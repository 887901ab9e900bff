"""K3's paged contract on the CPU: `decode_attention_int8(..., layout="paged",
tables=...)` reads a (P, page_size, H, D) int8 pool through per-row page
tables. Its plain version is held against the plain version on the engine's
gathered (B, L, H, D) view (the same function by construction: bit-equal)
and against the JAX kernel `decode_attention_int8(interpret=True)` on the
head-major transpose of that view, with page sizes 4 and 16, tables that
repeat pages and hold trash entries, and positions at 0, a page edge,
L - 1, past L and -1.

Inputs are drawn with numpy from a seed and handed to both sides.
"""

import numpy as np
import pytest
import torch
from test_torch_decode_attention import TOLERANCE, jax_reference, torch_args

from tritonk8ssupervisor_tpu_torch.ops.decode_attention import (
    decode_attention_int8,
    decode_attention_int8_plain,
    gather_pages,
)

H, D = 2, 16


def pool_inputs(b, n_pages, page_size, seed, w=None):
    """q, a (P, page_size, H, D) int8 pool with its (P, page_size, H)
    scales, quantised as the reference's test does, and int32 (B, n_pages)
    tables: distinct pages, one page repeated across rows and within a
    row, and the last column of every row on the trash page (P - 1)."""
    rng = np.random.default_rng(seed)
    pages = b * n_pages + 1
    q = rng.standard_normal((b, H, D) if w is None else (b, w, H, D)).astype(np.float32)
    k = rng.standard_normal((pages, page_size, H, D)).astype(np.float32)
    v = rng.standard_normal((pages, page_size, H, D)).astype(np.float32)
    ks = (np.abs(k).max(-1) / 127.0 + 1e-8).astype(np.float32)
    vs = (np.abs(v).max(-1) / 127.0 + 1e-8).astype(np.float32)
    k8 = np.clip(np.round(k / ks[..., None]), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(v / vs[..., None]), -127, 127).astype(np.int8)
    tables = rng.permutation(pages - 1)[: b * n_pages].reshape(b, n_pages).astype(np.int32)
    tables[1, 0] = tables[0, 1]  # one page shared by two rows (a prefix)
    tables[0, 2] = tables[0, 1]  # and read twice by one row
    tables[:, -1] = pages - 1  # the trash page
    return q, k8, ks, v8, vs, tables


def gathered_head_major(tables, *pool):
    """The gathered (B, L, H, ...) view of each pool operand, transposed to
    the JAX kernel's (B, H, L, ...)."""
    page_size = pool[0].shape[1]
    logical = np.arange(tables.shape[1] * page_size)
    views = [x[tables[:, logical // page_size], logical % page_size] for x in pool]
    return [np.ascontiguousarray(np.swapaxes(x, 1, 2)) for x in views]


@pytest.mark.parametrize("page_size", [4, 16])
@pytest.mark.parametrize("where", ["0", "page-edge", "L-1", "past-L", "negative"])
def test_paged_plain_version_matches_gathered_view_and_jax_kernel(page_size, where):
    b, n_pages = 3, 4
    length = n_pages * page_size
    pos = {"0": 0, "page-edge": page_size, "L-1": length - 1, "past-L": length + 3,
           "negative": -1}[where]
    q, k8, ks, v8, vs, tables = pool_inputs(b, n_pages, page_size, seed=page_size)
    args = torch_args(q, k8, ks, v8, vs)
    table = torch.from_numpy(tables)
    got = decode_attention_int8_plain(*args, pos, layout="paged", tables=table)
    assert got.shape == (b, H, D)
    # the engine's gather, then the dense function: bit-equal
    view = [gather_pages(t, table) for t in args[1:]]
    assert torch.equal(got, decode_attention_int8_plain(args[0], *view, pos, layout="blhd"))
    # the JAX kernel on the head-major transpose of the gathered view
    kh, ksh, vh, vsh = gathered_head_major(tables, k8, ks, v8, vs)
    want = jax_reference(q, kh, ksh, vh, vsh, pos)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOLERANCE, atol=TOLERANCE)
    # the entry point takes the plain version on CPU tensors, int64 tables too
    routed = decode_attention_int8(*args, pos, layout="paged", tables=table.long())
    assert torch.equal(routed, got)


@pytest.mark.parametrize("page_size", [4, 16])
def test_paged_per_row_and_per_query_positions_match_the_jax_kernel(page_size):
    """pos (B,) for the engine's decode step and (B, W) for its verify
    window, each (row, query) against the JAX kernel at that position."""
    b, n_pages, w = 3, 4, 5
    length = n_pages * page_size
    q, k8, ks, v8, vs, tables = pool_inputs(b, n_pages, page_size, seed=20 + page_size)
    kh, ksh, vh, vsh = gathered_head_major(tables, k8, ks, v8, vs)
    table = torch.from_numpy(tables)
    rows = np.array([page_size - 1, -1, length - 1], np.int32)
    got = decode_attention_int8(*torch_args(q, k8, ks, v8, vs), torch.from_numpy(rows),
                                layout="paged", tables=table).numpy()
    for i, p in enumerate(rows):
        np.testing.assert_allclose(got[i], jax_reference(q, kh, ksh, vh, vsh, int(p))[i],
                                   rtol=TOLERANCE, atol=TOLERANCE)

    qw, k8, ks, v8, vs, tables = pool_inputs(b, n_pages, page_size, seed=30 + page_size, w=w)
    kh, ksh, vh, vsh = gathered_head_major(tables, k8, ks, v8, vs)
    # windows that start at 0, straddle a page edge, and run past L
    starts = np.array([0, page_size - 2, length - 2])
    window = (starts[:, None] + np.arange(w)[None, :]).astype(np.int32)
    got = decode_attention_int8(*torch_args(qw, k8, ks, v8, vs), torch.from_numpy(window),
                                layout="paged", tables=torch.from_numpy(tables)).numpy()
    assert got.shape == (b, w, H, D)
    for j in range(w):
        for i in range(b):
            want = jax_reference(qw[:, j], kh, ksh, vh, vsh, int(window[i, j]))[i]
            np.testing.assert_allclose(got[i, j], want, rtol=TOLERANCE, atol=TOLERANCE)


def test_paged_shapes_that_do_not_fit_raise():
    q, k8, ks, v8, vs, tables = torch_args(*pool_inputs(2, 3, 4, seed=40))
    with pytest.raises(ValueError, match="tables"):
        decode_attention_int8(q, k8, ks, v8, vs, 3, layout="paged")
    with pytest.raises(ValueError, match="tables"):
        decode_attention_int8(q, k8, ks, v8, vs, 3, layout="blhd", tables=tables)
    with pytest.raises(ValueError, match="tables of shape"):
        decode_attention_int8(q, k8, ks, v8, vs, 3, layout="paged", tables=tables[:1])
    with pytest.raises(ValueError, match="cache"):
        decode_attention_int8(q, k8, ks[:, :2], v8, vs, 3, layout="paged", tables=tables)
    with pytest.raises(ValueError, match="pos of shape"):
        decode_attention_int8(q, k8, ks, v8, vs, torch.zeros(3, dtype=torch.int32),
                              layout="paged", tables=tables)
