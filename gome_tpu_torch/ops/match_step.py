"""The batched match step: T sequential ops on every row of an [S, T] grid.

The counterpart of ``gome_tpu/ops/pallas_match.py``. ``batch_step`` runs the
hand-written CUDA kernel ``ops/csrc/match_step.cu`` on CUDA tensors; on CPU
tensors it runs ``batch_step_reference``, the plain PyTorch version (a
T-step loop over ``engine/step.py::step_rows`` with every row vectorised).
The two compute the same function: books [S, 2, cap] and ops [S, T] in,
new books and a StepOutput with [S, T, K] records and [S, T] scalars out.
Neither writes its inputs.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.book import (
    GRID_I32_FIELDS,
    OUT_I32_FIELDS,
    RECORD_FIELDS,
    BookConfig,
    BookState,
    DeviceOp,
    StepOutput,
)
from ..engine.step import book_to_rows, rows_to_book, step_rows

_LIB = "match_step"
#: Largest cap the kernel takes (its cancel sums slot positions in 32 bits,
#: at most cap * cap); the engine's default max_cap is the same.
MAX_CAP = 1 << 14


def batch_step_reference(
    config: BookConfig, books: BookState, ops: DeviceOp
) -> tuple[BookState, StepOutput]:
    """Plain PyTorch version of the kernel: for t in 0..T-1 apply op[:, t]
    to every row at once. A column of NOPs leaves every book as it was and
    yields zeros, so it is not stepped."""
    rows = book_to_rows(books)
    s, k = ops.action.shape[0], config.max_fills
    nop = StepOutput(*(
        torch.zeros((s, k) if f in RECORD_FIELDS else (s,),
                    dtype=torch.int32 if f in OUT_I32_FIELDS else config.dtype,
                    device=books.price.device)
        for f in StepOutput._fields
    ))
    outs = []
    for t, live in enumerate((ops.action != 0).any(dim=0).tolist()):
        if not live:
            outs.append(nop)
            continue
        *rows, out = step_rows(config, *rows, DeviceOp(*(f[:, t] for f in ops)))
        outs.append(out)
    stacked = StepOutput(
        *(torch.stack([getattr(o, f) for o in outs], dim=1)
          for f in StepOutput._fields)
    )
    return rows_to_book(*rows), stacked


def _check(config: BookConfig, books: BookState, ops: DeviceOp) -> None:
    dev = books.price.device
    s, t = ops.action.shape
    cap, k, dt = config.cap, config.max_fills, config.dtype
    if s == 0 or t == 0:
        raise ValueError(f"empty op grid {tuple(ops.action.shape)}")
    if not 0 < k <= cap:
        raise ValueError(f"max_fills {k} must be in [1, cap={cap}]")
    if cap > MAX_CAP:
        raise ValueError(f"cap {cap} exceeds the kernel's limit {MAX_CAP}")
    want = dict(
        price=(dt, (s, 2, cap)), lots=(dt, (s, 2, cap)),
        seq=(config.seq_dtype, (s, 2, cap)), oid=(dt, (s, 2, cap)),
        uid=(dt, (s, 2, cap)), count=(torch.int32, (s, 2)),
        next_seq=(config.seq_dtype, (s,)),
    )
    for name, a in zip(BookState._fields, books):
        _check_tensor(f"books.{name}", a, dev, *want[name])
    for name, a in zip(DeviceOp._fields, ops):
        d = torch.int32 if name in GRID_I32_FIELDS else dt
        _check_tensor(f"ops.{name}", a, dev, d, (s, t))


def _check_tensor(name, a, dev, dtype, shape) -> None:
    if a.device != dev:
        raise ValueError(f"{name} is on {a.device}, books on {dev}")
    if a.dtype != dtype:
        raise ValueError(f"{name} has dtype {a.dtype}, expected {dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {shape}")
    if not a.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _library():
    from . import build

    lib = build.load(_LIB)
    if not getattr(lib, "_gome_typed", False):
        lib.gome_match_step.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.gome_match_step.restype = ctypes.c_int
        lib.gome_match_step_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.gome_match_step_smem_bytes.restype = ctypes.c_size_t
        lib.gome_match_step_smem_limit.argtypes = []
        lib.gome_match_step_smem_limit.restype = ctypes.c_longlong
        lib.gome_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gome_cuda_error_string.restype = ctypes.c_char_p
        lib._gome_typed = True
    return lib


def uses_shared_memory(cap: int, dtype: torch.dtype) -> bool:
    """Whether a row's working book fits the card's shared memory (else the
    kernel's device-memory instantiation runs). Needs the card."""
    lib = _library()
    item = torch.empty((), dtype=dtype).element_size()
    limit = lib.gome_match_step_smem_limit()
    if limit < 0:
        raise RuntimeError("cannot read the device's shared-memory limit")
    return lib.gome_match_step_smem_bytes(cap, item) <= limit


def batch_step(
    config: BookConfig, books: BookState, ops: DeviceOp
) -> tuple[BookState, StepOutput]:
    """Apply an [S, T] op grid to [S, 2, cap] books. CUDA tensors launch the
    kernel (and raise if it cannot launch); CPU tensors take
    ``batch_step_reference``. ``batch_step.launches`` counts the launches."""
    dev = books.price.device
    _check(config, books, ops)
    if dev.type == "cpu":
        return batch_step_reference(config, books, ops)
    if dev.type != "cuda":
        raise ValueError(f"batch_step runs on cuda or cpu tensors, got {dev}")
    s, t = ops.action.shape
    k = config.max_fills
    new_books = BookState(*(torch.empty_like(a) for a in books))
    out = StepOutput(
        *(
            torch.empty(
                (s, t, k) if f in RECORD_FIELDS else (s, t),
                dtype=torch.int32 if f in OUT_I32_FIELDS else config.dtype,
                device=dev,
            )
            for f in StepOutput._fields
        )
    )
    ptrs = [a.data_ptr() for a in (*books, *new_books, *ops, *out)]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(dev):
        lib = _library()
        shared = uses_shared_memory(config.cap, config.dtype)
        err = lib.gome_match_step(
            table, s, t, config.cap, k, books.price.element_size(),
            int(shared), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"match_step kernel did not launch (S={s}, T={t}, "
            f"cap={config.cap}, K={k}, {config.dtype}): "
            f"{lib.gome_cuda_error_string(err).decode()}"
        )
    _counted.launches += 1
    return new_books, out


batch_step.launches = 0
#: The function that holds the launch count: the count stays on it when a
#: caller wraps the module's ``batch_step`` (chip_smoke.step_timer does).
_counted = batch_step
