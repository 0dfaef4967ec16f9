"""The Hawkes bin scan (K5): the thinned event chain of one order-flow grid.

The counterpart of the ``lax.scan`` in ``gome_tpu/sim/flow.py::_bin_events``
(XLA code; the reference has no Pallas kernel for it). Given the grid's
draws (``sim/flow.py::draw_bins``), bin t of T does what the reference's
scan body does:

  occur = u_ev[t] < 1 - exp(-sum(lam) * dt)
  etype = argmax(g_ty[t] + log(lam + 1e-12))
  oid   = the order-id counter, advanced by one after an ADD
  lam   = fma(lam - mu, decay, mu) + occur * alpha[:, etype]

``hawkes_scan`` runs the hand-written CUDA kernel ``ops/csrc/hawkes_scan.cu``
on CUDA tensors and ``hawkes_scan_reference``, a Python loop over the bins
on tensors, on CPU tensors. What bounds the kernel is the serial dependency
chain from one bin's intensities to the next, not bytes. The kernel
speculates: a bin has seven outcomes (no event, or an event of one of six
types), so one round evaluates bin t and, on 28 more lanes, bins t + 1 to
t + 4 along the event-free path with each outcome of the bin before,
keeps the realized path (its first event and the bin after it, or all
five bins) and goes on from the kept lanes' intensities: about 4.2 bins a
round at the flow's stationary intensity, at least two. Four warps share
the round (two take the logs, one the occurrence test, one stages the draws
and the outputs). See the source's note for the layout and its cost.

Both take the six-term sum left to right and round every float32 operation
in the same order, and every speculative lane runs the serial path's own
operations on the intensities the serial path holds at its bin, so the
kept path is the serial one bit for bit. The decay is one fused
multiply-add, rounded once, as XLA's CPU compiler contracts the
reference's ``mu + (lam - mu) * decay``: the kernel calls ``__fmaf_rn``,
the plain version takes the product and the sum in float64 (the product is
exact there) and rounds to float32, which differs from one rounding only
when the float64 sum lands on a float32 midpoint (about 2**-28 of values).
So given equal ``occur`` and ``etype`` the intensities are bit-equal
(tolerance 0): lam's update never reads the sum, the exp or the log. The
argmax keeps the first maximum (a later type wins only when strictly
larger, as ``torch.argmax`` does for values that are not NaN). The kernel
and the plain version on the card call the same CUDA expf / logf; on the
CPU, and in XLA, exp and log may differ from them by an ulp, which can move
``occur`` or ``etype`` only for a draw within an ulp of its threshold.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

_LIB = "hawkes_scan"
N_EVENT_TYPES = 6
#: The floor inside log(lam + EPS) (float32, as the reference's).
EPS = 1e-12


class ScanOut(NamedTuple):
    occur: torch.Tensor  # i32 [T] 0/1: an event in the bin
    etype: torch.Tensor  # i32 [T] event type (drawn in every bin)
    oid: torch.Tensor  # i32 [T] order id an ADD in the bin takes
    lam: torch.Tensor  # f32 [6] intensities after the last bin
    next_oid: torch.Tensor  # i32 [] order-id counter after the last bin


def _constants(config) -> tuple[np.ndarray, np.ndarray, float, float]:
    """mu [6] and alpha [6, 6] as float32, the per-bin decay and -dt as
    float32 values (the reference pins all of them to float32; float32
    values are exact as Python floats)."""
    mu = np.asarray(config.mu(), np.float32)
    alpha = np.asarray(config.alpha(), np.float32)
    decay = np.float32(math.exp(-config.decay * config.dt))
    return mu, alpha, float(decay), -float(np.float32(config.dt))


def hawkes_scan_reference(config, lam, oid0, u_ev, g_ty) -> ScanOut:
    """Plain PyTorch version of the kernel: for t in 0..T-1 one bin of the
    chain, on tensors on the inputs' device."""
    dev = lam.device
    mu_np, alpha_np, decay, neg_dt = _constants(config)
    mu = torch.from_numpy(mu_np).to(dev)
    mu64 = mu.double()
    alpha = torch.from_numpy(alpha_np).to(dev)
    t_bins = u_ev.shape[0]
    occur = torch.empty(t_bins, dtype=torch.int32, device=dev)
    etype = torch.empty(t_bins, dtype=torch.int32, device=dev)
    oids = torch.empty(t_bins, dtype=torch.int32, device=dev)
    oid = oid0.clone()
    for t in range(t_bins):
        total = lam[0]
        for i in range(1, N_EVENT_TYPES):
            total = total + lam[i]
        p_event = 1.0 - torch.exp(total * neg_dt)
        occ = u_ev[t] < p_event
        e = torch.argmax(g_ty[t] + torch.log(lam + EPS))
        occur[t] = occ
        etype[t] = e
        oids[t] = oid
        oid = oid + (occ & (e // 2 != 1))
        decayed = ((lam - mu).double() * decay + mu64).float()  # fma
        lam = decayed + alpha[:, e] * occ
    return ScanOut(occur, etype, oids, lam, oid.to(torch.int32))


def _check(lam, oid0, u_ev, g_ty) -> None:
    dev = lam.device
    if u_ev.dim() != 1 or u_ev.shape[0] == 0:
        raise ValueError(f"u_ev must be a non-empty [T], got "
                         f"{tuple(u_ev.shape)}")
    t_bins = u_ev.shape[0]
    want = dict(lam=(lam, torch.float32, (N_EVENT_TYPES,)),
                oid0=(oid0, torch.int32, ()),
                u_ev=(u_ev, torch.float32, (t_bins,)),
                g_ty=(g_ty, torch.float32, (t_bins, N_EVENT_TYPES)))
    for name, (a, dtype, shape) in want.items():
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, lam on {dev}")
        if a.dtype != dtype:
            raise ValueError(f"{name} has dtype {a.dtype}, expected {dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _library():
    from . import build

    lib = build.load(_LIB)
    if not getattr(lib, "_gome_typed", False):
        lib.gome_hawkes_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.gome_hawkes_scan.restype = ctypes.c_int
        lib.gome_hawkes_error_string.argtypes = [ctypes.c_int]
        lib.gome_hawkes_error_string.restype = ctypes.c_char_p
        lib._gome_typed = True
    return lib


def _params(config) -> np.ndarray:
    """The kernel's host-side parameter block: mu, alpha (row-major), decay,
    -dt, all float32."""
    mu, alpha, decay, neg_dt = _constants(config)
    return np.concatenate([mu, alpha.ravel(),
                           np.asarray([decay, neg_dt], np.float32)])


def hawkes_scan(config, lam, oid0, u_ev, g_ty) -> ScanOut:
    """Run the chain of one grid: ``config`` a FlowConfig (its mu, alpha,
    decay and dt), ``lam`` f32 [6], ``oid0`` i32 [], ``u_ev`` f32 [T],
    ``g_ty`` f32 [T, 6]. CUDA tensors launch the kernel (and raise if it
    cannot launch); CPU tensors take ``hawkes_scan_reference``.
    ``hawkes_scan.launches`` counts the launches."""
    _check(lam, oid0, u_ev, g_ty)
    dev = lam.device
    if dev.type == "cpu":
        return hawkes_scan_reference(config, lam, oid0, u_ev, g_ty)
    if dev.type != "cuda":
        raise ValueError(f"hawkes_scan runs on cuda or cpu tensors, got {dev}")
    t_bins = u_ev.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    out = ScanOut(
        occur=torch.empty(t_bins, **i32), etype=torch.empty(t_bins, **i32),
        oid=torch.empty(t_bins, **i32),
        lam=torch.empty(N_EVENT_TYPES, dtype=torch.float32, device=dev),
        next_oid=torch.empty((), **i32),
    )
    params = _params(config)
    with torch.cuda.device(dev):
        lib = _library()
        err = lib.gome_hawkes_scan(
            params.ctypes.data, lam.data_ptr(), oid0.data_ptr(),
            u_ev.data_ptr(), g_ty.data_ptr(), t_bins, out.occur.data_ptr(),
            out.etype.data_ptr(), out.oid.data_ptr(), out.lam.data_ptr(),
            out.next_oid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"hawkes_scan kernel did not launch (T={t_bins}): "
            f"{lib.gome_hawkes_error_string(err).decode()}"
        )
    _counted.launches += 1
    return out


hawkes_scan.launches = 0
#: The function that holds the launch count: the count stays on it when a
#: caller wraps the module's ``hawkes_scan``.
_counted = hawkes_scan
