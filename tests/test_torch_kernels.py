"""Port vs reference, kernels: the plain PyTorch versions of the three
ported kernels against the reference's Pallas kernels (interpret mode, as
``tests/test_kernels.py`` runs them) and their ``ref.py`` oracles.

Inputs are made by numpy from a seed and fed to both packages; everything
runs on the CPU, where the port's ``ops.py`` wrappers take the plain
version (the CUDA kernels themselves are held against the same plain
versions on the GPU by ``chip_smoke.py``).  Tolerances are those of
``tests/test_kernels.py::_tol``: f32 2e-5 (sums are taken in another
order), bf16 2e-2 (one bf16 rounding of the output); copies are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.page_pack.ops import gather_pages as jax_gather_pages
from repro.kernels.page_pack.ops import scatter_pages as jax_scatter_pages
from repro.kernels.page_pack.ref import (page_gather_ref as jax_gather_ref,
                                         page_scatter_ref as jax_scatter_ref)
from repro.kernels.paged_attention.ops import \
    paged_attention as jax_paged_attention
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as jax_paged_attention_ref
from repro.models.attention_ops import paged_attention_xla

from repro_torch import kernels as tk
from repro_torch.compat import numpy_to_torch, torch_to_numpy
from repro_torch.kernels.page_pack import ops as pack_ops
from repro_torch.kernels.page_pack import page_pack as pack_kernel
from repro_torch.kernels.page_pack.ref import (page_gather_ref,
                                               page_scatter_ref)
from repro_torch.kernels.paged_attention import paged_attention as pa_kernel
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models.attention_ops import paged_attention_scan

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _both(x, name):
    """One numpy array -> (jax array, torch tensor) of dtype ``name``; both
    libraries round f32 -> bf16 to nearest-even, so the bits agree."""
    jd, td = DTYPES[name]
    return jnp.asarray(x, jd), torch.from_numpy(np.array(x)).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _paged_inputs(B, H, KVH, D, ps, NP, name, seed=0):
    rng = np.random.default_rng(seed)
    P = B * NP
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, ps, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, KVH, D)).astype(np.float32)
    pt = np.arange(P, dtype=np.int32).reshape(B, NP)
    lengths = np.linspace(1, NP * ps, B).astype(np.int32)
    return [_both(a, name) for a in (q, kp, vp)] + \
        [_both(pt, "int32"), _both(lengths, "int32")]


def _jax_kernel_and_ref(q, kp, vp, pt, ln, window=0):
    B, H, D = q.shape
    KVH = kp.shape[2]
    out = jax_paged_attention(q, kp, vp, pt, ln, window=window,
                              interpret=True)
    ref = jax_paged_attention_ref(
        q.reshape(B, KVH, H // KVH, D), kp.transpose(2, 0, 1, 3),
        vp.transpose(2, 0, 1, 3), pt, ln, window=window).reshape(B, H, D)
    return out, ref


PAGED_SHAPES = [
    (1, 4, 4, 16, 4, 2),     # MHA
    (2, 8, 2, 32, 8, 3),     # GQA
    (3, 8, 1, 64, 8, 4),     # MQA
    (2, 16, 8, 128, 16, 2),  # production-like head_dim
    (2, 10, 2, 32, 8, 3),    # group of 5 query heads (Qwen3-14B's G)
]


class TestPagedAttentionPlain:
    @pytest.mark.parametrize("B,H,KVH,D,ps,NP", PAGED_SHAPES)
    @pytest.mark.parametrize("name", ["float32", "bfloat16"])
    @pytest.mark.parametrize("fn", [paged_attention, paged_attention_ref,
                                    paged_attention_scan],
                             ids=["ops", "ref", "scan"])
    def test_matches_reference(self, B, H, KVH, D, ps, NP, name, fn):
        (jq, tq), (jk, tk_), (jv, tv), (jpt, tpt), (jl, tl) = \
            _paged_inputs(B, H, KVH, D, ps, NP, name)
        kern, ref = _jax_kernel_and_ref(jq, jk, jv, jpt, jl)
        out = fn(tq, tk_, tv, tpt, tl)
        assert out.dtype == tq.dtype and out.shape == tq.shape
        np.testing.assert_allclose(_f32(out), _f32(kern), **_tol(name))
        np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(name))

    @pytest.mark.parametrize("window", [8, 16])
    @pytest.mark.parametrize("fn", [paged_attention, paged_attention_scan],
                             ids=["ops", "scan"])
    def test_window_masking(self, window, fn):
        B, H, KVH, D, ps, NP = 2, 8, 2, 32, 8, 4
        (jq, tq), (jk, tk_), (jv, tv), (jpt, tpt), _ = \
            _paged_inputs(B, H, KVH, D, ps, NP, "float32", seed=1)
        jl, tl = _both(np.array([NP * ps, NP * ps // 2], np.int32), "int32")
        kern, ref = _jax_kernel_and_ref(jq, jk, jv, jpt, jl, window=window)
        xla = paged_attention_xla(jq, jk, jv, jpt, jl, window=window)
        out = fn(tq, tk_, tv, tpt, tl, window=window)
        for want in (kern, ref, xla):
            np.testing.assert_allclose(_f32(out), _f32(want), atol=2e-5,
                                       rtol=2e-5)

    @pytest.mark.parametrize("fn", [paged_attention, paged_attention_scan],
                             ids=["ops", "scan"])
    def test_unmapped_pages_masked(self, fn):
        """-1 page-table entries (non-resident) contribute nothing."""
        B, H, KVH, D, ps = 1, 4, 4, 16, 4
        rng = np.random.default_rng(2)
        _, q = _both(rng.standard_normal((B, H, D)).astype(np.float32),
                     "float32")
        jk, kp = _both(rng.standard_normal((4, ps, KVH, D))
                       .astype(np.float32), "float32")
        jv, vp = _both(rng.standard_normal((4, ps, KVH, D))
                       .astype(np.float32), "float32")
        ln = torch.tensor([8], dtype=torch.int32)
        a = fn(q, kp, vp, torch.tensor([[0, 1, -1, -1]], dtype=torch.int32),
               ln)
        b = fn(q, kp, vp, torch.tensor([[0, 1, 2, 3]], dtype=torch.int32),
               ln)
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-6)
        want = jax_paged_attention(
            jnp.asarray(q.numpy()), jk, jv,
            jnp.array([[0, 1, -1, -1]], jnp.int32), jnp.array([8], jnp.int32),
            interpret=True)
        np.testing.assert_allclose(_f32(a), _f32(want), atol=2e-5, rtol=2e-5)

    def test_strided_pool_needs_no_transpose(self):
        """A per-layer slice of a stacked (L, P, ps, KVH, D) pool is read
        as it lies (the reference wrapper transposes the pool per call)."""
        rng = np.random.default_rng(3)
        L, B, H, KVH, D, ps, NP = 3, 2, 4, 2, 16, 4, 2
        pools = torch.from_numpy(rng.standard_normal(
            (2, L, B * NP, ps, KVH, D)).astype(np.float32))
        q = torch.from_numpy(rng.standard_normal((B, H, D))
                             .astype(np.float32))
        pt = torch.arange(B * NP, dtype=torch.int32).reshape(B, NP)
        ln = torch.tensor([5, 8], dtype=torch.int32)
        out = paged_attention(q, pools[0, 1], pools[1, 1], pt, ln)
        want = jax_paged_attention(
            jnp.asarray(q.numpy()), jnp.asarray(pools[0, 1].numpy()),
            jnp.asarray(pools[1, 1].numpy()), jnp.asarray(pt.numpy()),
            jnp.asarray(ln.numpy()), interpret=True)
        np.testing.assert_allclose(_f32(out), _f32(want), atol=2e-5,
                                   rtol=2e-5)


class TestPagePackPlain:
    @pytest.mark.parametrize("P,n,elems", [(8, 4, 32), (64, 16, 128),
                                           (16, 16, 64), (8, 5, 7)])
    @pytest.mark.parametrize("name", ["float32", "bfloat16", "int32"])
    def test_gather(self, P, n, elems, name):
        rng = np.random.default_rng(P * 1000 + n)
        if name == "int32":
            data = rng.integers(0, 100, (P, elems)).astype(np.int32)
        else:
            data = rng.standard_normal((P, elems)).astype(np.float32)
        jpool, tpool = _both(data, name)
        idx = rng.permutation(P)[:n].astype(np.int32)
        idx[0] = -1                                   # unmapped -> row 0
        jidx, tidx = _both(idx, "int32")
        want_kernel = jax_gather_pages(jpool, jidx, interpret=True)
        want_ref = jax_gather_ref(jpool, jidx)
        for out in (pack_ops.gather_pages(tpool, tidx),
                    page_gather_ref(tpool, tidx)):
            np.testing.assert_array_equal(_f32(out), _f32(want_kernel))
            np.testing.assert_array_equal(_f32(out), _f32(want_ref))

    def test_gather_into_out(self):
        pool = torch.arange(48, dtype=torch.float32).reshape(6, 2, 4)
        idx = torch.tensor([4, 0, 5], dtype=torch.int32)
        out = torch.empty((3, 2, 4))
        res = pack_ops.gather_pages(pool, idx, out=out)
        assert res.data_ptr() == out.data_ptr()
        np.testing.assert_array_equal(out.numpy(), pool.numpy()[[4, 0, 5]])
        with pytest.raises(ValueError):
            pack_ops.gather_pages(pool, idx, out=torch.empty((3, 8)))

    def test_scatter_preserves_untouched_rows(self):
        rng = np.random.default_rng(7)
        jpool, tpool = _both(rng.standard_normal((16, 32)).astype(np.float32),
                             "float32")
        jidx, tidx = _both(np.array([2, 9, 14], np.int32), "int32")
        jblk, tblk = _both(rng.standard_normal((3, 32)).astype(np.float32),
                           "float32")
        before = tpool.clone()
        want = jax_scatter_pages(jpool.copy(), jidx, jblk, interpret=True)
        want_ref = jax_scatter_ref(jpool, jidx, jblk)
        out = pack_ops.scatter_pages(tpool, tidx, tblk)
        assert out.data_ptr() == tpool.data_ptr()      # in place
        np.testing.assert_array_equal(_f32(out), _f32(want))
        np.testing.assert_array_equal(_f32(out), _f32(want_ref))
        untouched = [r for r in range(16) if r not in (2, 9, 14)]
        np.testing.assert_array_equal(out[untouched].numpy(),
                                      before[untouched].numpy())
        np.testing.assert_array_equal(
            page_scatter_ref(before.clone(), tidx, tblk).numpy(), out.numpy())

    def test_gather_scatter_roundtrip(self):
        rng = np.random.default_rng(8)
        jpool, tpool = _both(rng.standard_normal((32, 8, 16))
                             .astype(np.float32), "float32")
        jidx, tidx = _both(np.array([5, 1, 30, 7], np.int32), "int32")
        pages = pack_ops.gather_pages(tpool, tidx)
        jpages = jax_gather_pages(jpool, jidx, interpret=True)
        np.testing.assert_array_equal(pages.numpy(), np.asarray(jpages))
        pool2 = pack_ops.scatter_pages(torch.zeros_like(tpool), tidx, pages)
        jpool2 = jax_scatter_pages(jnp.zeros_like(jpool), jidx, jpages,
                                   interpret=True)
        np.testing.assert_array_equal(pool2.numpy(), np.asarray(jpool2))


class TestWrappersNeverFallBack:
    """The kernel bindings take CUDA tensors only and raise on anything
    else; only ``ops.py`` may route a CPU tensor to the plain version."""

    def test_paged_attention_binding_rejects_cpu(self):
        q = torch.zeros((1, 4, 16))
        pool = torch.zeros((2, 4, 4, 16))
        with pytest.raises(ValueError, match="CUDA"):
            pa_kernel.paged_attention_kernel(
                q, pool, pool, torch.zeros((1, 2), dtype=torch.int32),
                torch.ones((1,), dtype=torch.int32))

    @pytest.mark.parametrize("fn", ["page_gather", "page_scatter"])
    def test_page_pack_bindings_reject_cpu(self, fn):
        pool = torch.zeros((4, 8))
        idx = torch.zeros((2,), dtype=torch.int32)
        args = (pool, idx) if fn == "page_gather" \
            else (pool, idx, torch.zeros((2, 8)))
        with pytest.raises(ValueError, match="CUDA"):
            getattr(pack_kernel, fn)(*args)

    def test_plain_versions_do_not_count_as_launches(self):
        tk.reset_launch_counts()
        pool = torch.zeros((4, 8))
        pack_ops.gather_pages(pool, torch.tensor([1], dtype=torch.int32))
        assert tk.launch_counts() == {"paged_attention": 0, "page_gather": 0,
                                      "page_scatter": 0}


class TestCompatDtypes:
    @pytest.mark.parametrize("name", ["float32", "bfloat16", "int32"])
    def test_numpy_torch_roundtrip(self, name):
        jd, _ = DTYPES[name]
        a = np.asarray(jnp.arange(24, dtype=jd).reshape(4, 6))
        t = numpy_to_torch(a)
        assert str(t.dtype).endswith(name)
        back = torch_to_numpy(t)
        assert back.dtype == a.dtype
        np.testing.assert_array_equal(back, a)
