"""Book state of the PyTorch port against gome_tpu/engine/book.py: init,
slot growth, lane growth and the depth view, leaf for leaf, both dtypes."""

import numpy as np
import pytest
import torch

from gome_tpu.engine import book as jbook
from gome_tpu_torch.engine import book as tbook
from test_torch_bridge import (
    DTYPES,
    assert_leaves_equal,
    jnp_dtype,
    torch_books,
    torch_dtype,
)


def _configs(dtype, cap=16, k=4):
    return (jbook.BookConfig(cap=cap, max_fills=k, dtype=jnp_dtype(dtype)),
            tbook.BookConfig(cap=cap, max_fills=k, dtype=torch_dtype(dtype)))


def _random_books(dtype, s=5, cap=16, seed=0):
    """A numpy [s, 2, cap] book with arbitrary (not necessarily sorted)
    contents: growth must carry any contents through unchanged."""
    rng = np.random.default_rng(seed)
    d = np.dtype(dtype)
    v = lambda: rng.integers(1, 1000, size=(s, 2, cap)).astype(d)
    return jbook.BookState(
        price=v(), lots=v(), seq=rng.integers(1, 99, (s, 2, cap)).astype(np.int32),
        oid=v(), uid=v(), count=rng.integers(0, cap, (s, 2)).astype(np.int32),
        next_seq=rng.integers(0, 99, s).astype(np.int32),
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_books_matches(dtype):
    jc, tc = _configs(dtype)
    assert_leaves_equal(tbook.init_books(tc, 6, "cpu"), jbook.init_books(jc, 6))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grow_books_matches(dtype):
    books = _random_books(dtype)
    got = tbook.grow_books(torch_books(books), 64)
    assert_leaves_equal(got, jbook.grow_books(books, 64))
    same = torch_books(books)
    assert tbook.grow_books(same, 16) is same
    with pytest.raises(ValueError, match="shrink"):
        tbook.grow_books(same, 8)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grow_lanes_matches(dtype):
    books = _random_books(dtype)
    got = tbook.grow_lanes(torch_books(books), 11)
    assert_leaves_equal(got, jbook.grow_lanes(books, 11))
    with pytest.raises(ValueError, match="shrink"):
        tbook.grow_lanes(torch_books(books), 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_growth_leaves_its_input_unchanged(dtype):
    books = torch_books(_random_books(dtype))
    before = [a.clone() for a in books]
    tbook.grow_books(books, 32)
    tbook.grow_lanes(books, 9)
    for a, b in zip(books, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("side", [0, 1])
def test_book_depth_matches(side):
    cap = 12
    price = np.array([[105, 105, 104, 101, 101, 101, 99, 0, 0, 0, 0, 0],
                      [100, 100, 102, 103, 103, 110, 0, 0, 0, 0, 0, 0]],
                     np.int64)
    book = jbook.BookState(
        price=price, lots=(price > 0) * 3, seq=np.zeros((2, cap), np.int32),
        oid=np.zeros((2, cap), np.int64), uid=np.zeros((2, cap), np.int64),
        count=np.array([7, 6], np.int32), next_seq=np.int32(0),
    )
    want = jbook.book_depth(book, side, 3)
    tb = tbook.BookState(*(torch.as_tensor(np.asarray(a)) for a in book))
    got = tbook.book_depth(tb, side, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_config_dtype_names_and_devices():
    assert tbook.BookConfig(dtype="int32").dtype is torch.int32
    assert tbook.BookConfig(dtype=np.int64).dtype is torch.int64
    assert tbook.BookConfig().seq_dtype is torch.int32
    assert tbook.numpy_dtype(torch.int32) == np.int32
    assert tbook.resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbook.resolve_device(None)
