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

import math

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
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.page_pack import ops as pack_ops
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.page_pack import page_pack as pack_kernel
from repro_torch.kernels.page_pack.ref import (page_gather_ref,
                                               page_scatter_ref)
from repro_torch.kernels.paged_attention import paged_attention as pa_kernel
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_attention_split_ref)
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
    (2, 32, 8, 80, 16, 2),   # H2O-Danube-1.8B's heads and head_dim
    (1, 32, 32, 112, 8, 3),  # Zamba2-7B's heads and head_dim
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

    @pytest.mark.parametrize("case", ["length_0", "all_unmapped",
                                      "window_unmapped"])
    @pytest.mark.parametrize("fn", [paged_attention, paged_attention_ref,
                                    paged_attention_scan],
                             ids=["ops", "ref", "scan"])
    def test_no_valid_position_matches_reference(self, case, fn):
        """A row with no valid position: the reference's softmax over equal
        -1e30 scores is the mean of every V row it reads (all NP·ps
        positions, an unmapped page read as frame 0); the CUDA kernel is
        held to the same on the card by ``chip_smoke.py``."""
        B, H, KVH, D, ps, NP = 2, 4, 2, 16, 4, 3
        (jq, tq), (jk, tk_), (jv, tv), _, _ = \
            _paged_inputs(B, H, KVH, D, ps, NP, "float32", seed=4)
        pt = np.arange(B * NP, dtype=np.int32).reshape(B, NP)
        lengths = np.array([5, 9], np.int32)
        window = 0
        if case == "length_0":
            lengths[0] = 0
        elif case == "all_unmapped":
            pt[1] = -1
        else:                      # the window's pages are all unmapped
            pt[1, 1:] = -1
            window = 2
        jl, tl = _both(lengths, "int32")
        jpt, tpt = _both(pt, "int32")
        kern, ref = _jax_kernel_and_ref(jq, jk, jv, jpt, jl, window=window)
        out = fn(tq, tk_, tv, tpt, tl, window=window)
        np.testing.assert_allclose(_f32(out), _f32(kern), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-5,
                                   rtol=2e-5)
        row = 0 if case == "length_0" else 1
        frames = np.maximum(pt[row], 0)
        mean = np.asarray(jv)[frames].reshape(NP * ps, KVH, D).mean(axis=0)
        np.testing.assert_allclose(
            _f32(out)[row].reshape(KVH, H // KVH, D),
            np.broadcast_to(mean[:, None], (KVH, H // KVH, D)), atol=2e-5)

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


_JAX_RESULTS = {}


def _jax_once(key, *args, **kw):
    """The JAX kernel (interpret mode) and oracle on one input set, computed
    once per key: the split cases reuse them for every ``n_splits``."""
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = _jax_kernel_and_ref(*args, **kw)
    return _JAX_RESULTS[key]


SPLITS = [1, 2, 3, 8, 16]
# (rows a tile, consumer warps): the kernel's bf16 and f32 tilings (8 rows
# a warp), and a small one under which the tests' short contexts span
# several tiles and splits
TILINGS = [(64, 8), (32, 4), (4, 2)]


class TestPagedAttentionSplit:
    """The CUDA kernel's algorithm (visible range -> splits -> tiles ->
    warp slices, two-level rank-order combine) in plain torch, held to the
    reference's Pallas kernel and oracle at the same tolerances."""

    @staticmethod
    def _check(out, want, name):
        for w in want:
            np.testing.assert_allclose(_f32(out), _f32(w), **_tol(name))

    @pytest.mark.parametrize("tiling", TILINGS, ids=["t64w8", "t32w4", "t4w2"])
    @pytest.mark.parametrize("n_splits", SPLITS)
    @pytest.mark.parametrize("B,H,KVH,D,ps,NP", PAGED_SHAPES)
    @pytest.mark.parametrize("name", ["float32", "bfloat16"])
    def test_matches_reference(self, B, H, KVH, D, ps, NP, name, n_splits,
                               tiling):
        (jq, tq), (jk, tk_), (jv, tv), (jpt, tpt), (jl, tl) = \
            _paged_inputs(B, H, KVH, D, ps, NP, name)
        want = _jax_once(("shape", B, H, KVH, D, ps, NP, name), jq, jk, jv,
                         jpt, jl)
        out = paged_attention_split_ref(tq, tk_, tv, tpt, tl,
                                        n_splits=n_splits,
                                        tile_rows=tiling[0], warps=tiling[1])
        assert out.dtype == tq.dtype and out.shape == tq.shape
        self._check(out, want, name)

    @pytest.mark.parametrize("n_splits", SPLITS)
    @pytest.mark.parametrize("window", [8, 16])
    def test_window(self, window, n_splits):
        B, H, KVH, D, ps, NP = 2, 8, 2, 32, 8, 4
        (jq, tq), (jk, tk_), (jv, tv), (jpt, tpt), _ = \
            _paged_inputs(B, H, KVH, D, ps, NP, "float32", seed=1)
        jl, tl = _both(np.array([NP * ps, NP * ps // 2 + 3], np.int32),
                       "int32")
        want = _jax_once(("window", window), jq, jk, jv, jpt, jl,
                         window=window)
        for tiling in TILINGS:
            out = paged_attention_split_ref(
                tq, tk_, tv, tpt, tl, window=window, n_splits=n_splits,
                tile_rows=tiling[0], warps=tiling[1])
            self._check(out, want, "float32")

    @pytest.mark.parametrize("n_splits", SPLITS)
    @pytest.mark.parametrize("case", ["unmapped_inside", "masked_split",
                                      "masked_split_window"])
    def test_masked_rows(self, case, n_splits):
        """An unmapped page inside the context, and splits that see only
        masked rows (their pages unmapped, or before the window)."""
        B, H, KVH, D, ps, NP = 1, 10, 2, 16, 4, 4
        (jq, tq), (jk, tk_), (jv, tv), _, _ = \
            _paged_inputs(B, H, KVH, D, ps, NP, "float32", seed=5)
        pt = np.arange(NP, dtype=np.int32).reshape(1, NP)
        window = 0
        if case == "unmapped_inside":
            pt[0, 2] = -1
        elif case == "masked_split":
            pt[0, :2] = -1
        else:
            window = 5
        jpt, tpt = _both(pt, "int32")
        jl, tl = _both(np.array([NP * ps], np.int32), "int32")
        want = _jax_once(("masked", case), jq, jk, jv, jpt, jl, window=window)
        out = paged_attention_split_ref(tq, tk_, tv, tpt, tl, window=window,
                                        n_splits=n_splits, tile_rows=4,
                                        warps=2)
        self._check(out, want, "float32")

    @pytest.mark.parametrize("n_splits", SPLITS)
    @pytest.mark.parametrize("case", ["length_0", "all_unmapped",
                                      "window_unmapped"])
    def test_no_valid_position(self, case, n_splits):
        """The cases of ``TestPagedAttentionPlain::
        test_no_valid_position_matches_reference``: decided after the
        combine, the mean of the V rows of all NP·ps positions."""
        B, H, KVH, D, ps, NP = 2, 4, 2, 16, 4, 3
        (jq, tq), (jk, tk_), (jv, tv), _, _ = \
            _paged_inputs(B, H, KVH, D, ps, NP, "float32", seed=4)
        pt = np.arange(B * NP, dtype=np.int32).reshape(B, NP)
        lengths = np.array([5, 9], np.int32)
        window = 0
        if case == "length_0":
            lengths[0] = 0
        elif case == "all_unmapped":
            pt[1] = -1
        else:
            pt[1, 1:] = -1
            window = 2
        jl, tl = _both(lengths, "int32")
        jpt, tpt = _both(pt, "int32")
        want = _jax_once(("no_valid", case), jq, jk, jv, jpt, jl,
                         window=window)
        for tiling in TILINGS:
            out = paged_attention_split_ref(
                tq, tk_, tv, tpt, tl, window=window, n_splits=n_splits,
                tile_rows=tiling[0], warps=tiling[1])
            self._check(out, want, "float32")


class TestSplitPlan:
    """``split_plan`` picks the cluster size from shapes alone, with the
    counts of co-resident clusters the card reports."""

    # clusters of N blocks an H100 holds at once at the serving instance
    # (cudaOccupancyMaxActiveClusters, one block an SM, a cluster in a GPC)
    H100_ACTIVE = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}

    @pytest.mark.parametrize("B,KVH,NP,ps,n_sm,want", [
        (4, 8, 4, 256, 132, 2),      # serving shape: 32 clusters, 30 of 4 fit
        (1, 8, 4, 256, 132, 8),      # serving, batch 1: 64 blocks
        (1, 8, 128, 256, 132, 8),    # native context, batch 1
        (3, 8, 4, 256, 132, 4),      # 24 clusters: 30 of 4 fit, 15 of 8
        (1, 1, 1, 16, 132, 1),       # one tile: nothing to split
        (1, 1, 1, 150, 132, 2),      # three 64-row tiles: 2
        (1, 1, 1, 200, 132, 4),      # four
        (64, 8, 4, 256, 132, 1),     # B·KVH fills the card
        (17, 8, 4, 256, 132, 1),
    ])
    def test_values(self, B, KVH, NP, ps, n_sm, want):
        assert pa_kernel.split_plan(
            B, KVH, NP, ps, n_sm, active_clusters=self.H100_ACTIVE.get) == want

    @pytest.mark.parametrize("B", [1, 2, 3, 4, 8, 16, 32, 64])
    @pytest.mark.parametrize("KVH", [1, 2, 8])
    @pytest.mark.parametrize("max_cluster", [8, 16])
    def test_bounds(self, B, KVH, max_cluster):
        for NP, ps in ((1, 4), (2, 16), (4, 256), (128, 256)):
            for tile in (32, 64):
                n = pa_kernel.split_plan(B, KVH, NP, ps, 132, max_cluster,
                                         tile_rows=tile,
                                         active_clusters=self.H100_ACTIVE.get)
                tiles = -(-(NP * ps) // tile)
                assert 1 <= n <= max_cluster and n <= max(1, tiles)
                assert n & (n - 1) == 0                  # a power of two
                if B * KVH >= 132:
                    assert n == 1
                else:
                    assert B * KVH * n <= 132            # at most one an SM
                    assert n == 1 or B * KVH <= self.H100_ACTIVE[n]

    @pytest.mark.parametrize("B,NP,want", [(4, 4, 2), (1, 4, 8), (1, 128, 8),
                                           (2, 4, 4), (3, 4, 4), (8, 4, 2),
                                           (16, 4, 1), (17, 4, 1)])
    def test_clusters_must_fit_at_once(self, B, NP, want):
        """At B=4, 32 clusters of 4 would need 32 of the 30 that fit: the
        last two would run as a second wave, so N is 2."""
        n = pa_kernel.split_plan(B, 8, NP, 256, 132,
                                 active_clusters=self.H100_ACTIVE.get)
        assert n == want
        assert B * 8 <= self.H100_ACTIVE[n] or n == 1

    def test_head_groups_count_as_blocks(self):
        fits = self.H100_ACTIVE.get
        assert pa_kernel.split_plan(2, 8, 4, 256, 132, head_groups=2,
                                    active_clusters=fits) == 2
        assert pa_kernel.split_plan(2, 8, 4, 256, 132,
                                    active_clusters=fits) == 4

    @pytest.mark.parametrize("dtype,D,ps,seg", [
        (torch.bfloat16, 128, 256, 64), (torch.bfloat16, 128, 2, 2),
        (torch.bfloat16, 128, 6, 2), (torch.bfloat16, 32, 4, 4),
        (torch.bfloat16, 16, 4, 4), (torch.bfloat16, 16, 12, 4),
        (torch.float32, 128, 256, 32), (torch.float32, 128, 1, 1),
        (torch.float32, 64, 3, 1), (torch.float32, 16, 2, 2),
        (torch.float32, 16, 8, 8), (torch.bfloat16, 80, 256, 64),
        (torch.bfloat16, 112, 256, 64), (torch.float32, 80, 256, 32),
        (torch.float32, 112, 3, 1), (torch.bfloat16, 80, 2, 2)])
    def test_page_sizes_served(self, dtype, D, ps, seg):
        assert pa_kernel.bulk_segment(ps, D, dtype) == seg

    @pytest.mark.parametrize("dtype,D,ps", [
        (torch.bfloat16, 128, 1), (torch.bfloat16, 128, 3),
        (torch.bfloat16, 64, 255), (torch.bfloat16, 16, 2),
        (torch.bfloat16, 16, 6), (torch.float32, 16, 1),
        (torch.float32, 16, 3)])
    def test_page_sizes_refused(self, dtype, D, ps):
        """The page sizes a bulk copy cannot serve (below 128 bytes, or a
        stage of more than 32 copies), once refused, now go to the
        producer's row copies: ``bulk_segment`` is 0, and the kernel
        launches."""
        assert pa_kernel.bulk_segment(ps, D, dtype) == 0

    @pytest.mark.parametrize("D", pa_kernel.SUPPORTED_HEAD_DIMS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_every_page_size_has_a_copy(self, dtype, D):
        """Every ps >= 1 is served: a bulk segment that divides the page
        and the tile, spans a multiple of 128 bytes of the instance's rows
        and needs at most 32 copies a stage, or 0 (row copies); 256-token
        pages take whole-tile segments, as before."""
        tile = pa_kernel.TILE_ROWS[dtype]
        row = pa_kernel.instance_head_dim(D) * dtype.itemsize
        for ps in range(1, 520):
            seg = pa_kernel.bulk_segment(ps, D, dtype)
            if seg:
                assert ps % seg == 0 and tile % seg == 0
                assert seg * row % 128 == 0 and tile // seg <= 32
            else:
                g = math.gcd(ps, tile)
                assert g * row % 128 != 0 or tile // g > 32
        assert pa_kernel.bulk_segment(256, D, dtype) == tile
        with pytest.raises(ValueError, match="page size 0"):
            pa_kernel.bulk_segment(0, D, dtype)

    @pytest.mark.parametrize("D,inst", [(16, 16), (32, 32), (64, 64),
                                        (80, 128), (112, 128), (128, 128)])
    def test_instance_head_dim(self, D, inst):
        """80 and 112 run the 128 instance (columns past D zero-filled)."""
        assert pa_kernel.instance_head_dim(D) == inst

    @pytest.mark.parametrize("D", [8, 48, 96, 192, 256])
    def test_unsupported_head_dim_raises(self, D):
        with pytest.raises(ValueError, match=f"head_dim {D}"):
            pa_kernel.instance_head_dim(D)


def _kernel_head_dims(cfg):
    """(head_dim that decode sends to ``paged_attention``, head_dim that
    training and prefill send to flash attention); None where the family
    has no such call (MLA decodes through its latent page scan; xLSTM has
    no attention)."""
    if cfg.family == "xlstm":
        return None, None
    if cfg.family == "mla_moe":
        return None, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return cfg.head_dim, cfg.head_dim


class TestHeadDimCoverage:
    """Every config's published head dims are served by the CUDA kernels
    (the CPU tests run at reduced head dims, which cannot show a gap):
    Zamba2-7B's 112 among them, ahead of its family's port."""

    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_kernels_serve_the_published_head_dims(self, arch):
        decode, train = _kernel_head_dims(get_config(arch))
        if decode is not None:
            assert decode in pa_kernel.SUPPORTED_HEAD_DIMS
            pa_kernel.instance_head_dim(decode)
        if train is not None:
            assert train in fa_kernel.SUPPORTED_HEAD_DIMS
            for dtype in (torch.bfloat16, torch.float32):
                fa_kernel.route(dtype, train)

    def test_named_gaps_are_closed(self):
        assert get_config("h2o_danube_1_8b").head_dim == 80
        assert get_config("zamba2_7b").head_dim == 112
        assert _kernel_head_dims(get_config("deepseek_v3_671b"))[1] == 192


class TestCopyPlan:
    """``page_pack.copy_plan``: bulk copies, cut by ``piece_plan``, for
    large copies; the word loop, which takes no plan, for small ones."""

    @pytest.mark.parametrize("n,row_bytes,want", [
        (160, 524288, (pack_kernel.BULK, 32768, 528, 3)),   # Qwen3-14B's rows
        (96, 327680, (pack_kernel.BULK, 32768, 528, 3)),    # H2O-Danube's
        (96, 327696, (pack_kernel.BULK, 29792, 528, 3)),
        (16, 262144, (pack_kernel.WORDS, 0, 0, 0)),         # ckv_pool rows
        (16, 32768, (pack_kernel.WORDS, 0, 0, 0)),          # krope_pool rows
        (1, 16, (pack_kernel.WORDS, 0, 0, 0)),
        (3, 100000, (pack_kernel.WORDS, 0, 0, 0))])
    def test_values(self, n, row_bytes, want):
        assert pack_kernel.copy_plan(n, row_bytes, 132) == want

    @pytest.mark.parametrize("n", [1, 2, 16, 160, 2000])
    @pytest.mark.parametrize("row_bytes", [16, 4096, 32768, 262144, 524288,
                                           327680, 1 << 22])
    @pytest.mark.parametrize("n_sm", [1, 132])
    def test_bounds(self, n, row_bytes, n_sm):
        mode, piece, blocks, stages = pack_kernel.copy_plan(n, row_bytes,
                                                            n_sm)
        if mode == pack_kernel.BULK:
            per_row = -(-row_bytes // piece)
            assert n * row_bytes >= pack_kernel.BULK_MIN_BYTES
            assert piece % 16 == 0
            assert piece <= pack_kernel.MAX_PIECE
            assert per_row == -(-row_bytes // pack_kernel.MAX_PIECE)
            assert piece - 16 < -(-row_bytes // per_row) <= piece
            assert 1 <= blocks <= pack_kernel.BLOCKS_PER_SM * n_sm
            assert blocks <= n * per_row
            assert stages == pack_kernel.STAGES
        else:
            assert mode == pack_kernel.WORDS
            assert n * row_bytes < pack_kernel.BULK_MIN_BYTES
            assert (piece, blocks, stages) == (0, 0, 0)

    def test_piece_plan_largest_pieces(self):
        """Large copies: pieces of MAX_PIECE where they divide the row
        (every page row of the repo's configs), else the fewest pieces a
        row evened out, the last one shorter; a grid of at most
        ``BLOCKS_PER_SM`` blocks a SM, fewer where there are fewer
        pieces."""
        assert pack_kernel.piece_plan(160, 524288, 132) == (32768, 528)
        assert pack_kernel.piece_plan(96, 327680, 132) == (32768, 528)
        piece, blocks = pack_kernel.piece_plan(96, 327696, 132)
        assert 0 < 327696 - 10 * piece < piece == 29792
        assert pack_kernel.piece_plan(2, 327680, 132) == (32768, 20)


class TestPagePackPlain:
    @pytest.mark.parametrize("P,n,elems", [(8, 4, 32), (64, 16, 128),
                                           (16, 16, 64), (8, 5, 7),
                                           (64, 16, 256 * 64),
                                           (8, 4, 256 * 512)])
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
        q = torch.zeros((1, 8, 2, 16), requires_grad=True)
        kv = torch.zeros((1, 8, 1, 16))
        fa_ops.flash_attention(q, kv, kv).sum().backward()
        assert tk.launch_counts() == {
            "paged_attention": 0, "page_gather": 0, "page_scatter": 0,
            "flash_attention": 0, "flash_attention_bwd": 0}

    @pytest.mark.parametrize("fn", ["flash_attention_fwd",
                                    "flash_attention_bwd"])
    def test_flash_attention_bindings_reject_cpu(self, fn):
        q = torch.zeros((1, 8, 2, 16))
        kv = torch.zeros((1, 8, 1, 16))
        args = (q, kv, kv) if fn == "flash_attention_fwd" else \
            (q, kv, kv, q, torch.zeros((1, 2, 8)), q)
        with pytest.raises(ValueError, match="CUDA"):
            getattr(fa_kernel, fn)(*args)

    def test_flash_attention_wrapper_sends_non_cpu_tensors_to_the_kernel(
            self):
        """Only a CPU tensor takes the plain version: any other device goes
        to the kernel binding, which raises rather than fall back."""
        q = torch.zeros((1, 8, 2, 16), device="meta")
        kv = torch.zeros((1, 8, 1, 16), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            fa_ops.flash_attention(q, kv, kv)

    def test_cuda_typed_call_without_a_gpu_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the CUDA call would run")
        with pytest.raises((RuntimeError, AssertionError)):
            q = torch.zeros((1, 8, 2, 16), device="cuda")
            fa_ops.flash_attention(q, q[:, :, :1], q[:, :, :1])


@pytest.fixture
def one_rank_mesh():
    """A one-dim DeviceMesh over a one-rank gloo group, torn down after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


class TestNoDTensorReachesAKernel:
    """Every ``ops.py`` wrapper raises ``TypeError`` for a DTensor, whatever
    the device of its local tensor (``meta`` would otherwise go to the
    kernel binding): the model's regions hand the wrappers local shards."""

    @staticmethod
    def _d(mesh, t, device):
        from torch.distributed.tensor import DTensor, Replicate
        return DTensor.from_local(t.to(device), mesh, [Replicate()],
                                  run_check=False)

    @pytest.mark.parametrize("device", ["cpu", "meta"])
    def test_paged_attention(self, one_rank_mesh, device):
        q = self._d(one_rank_mesh, torch.zeros((1, 4, 16)), device)
        pool = torch.zeros((2, 4, 4, 16), device=device)
        with pytest.raises(TypeError, match="DTensor"):
            paged_attention(q, pool, pool,
                            torch.zeros((1, 2), dtype=torch.int32),
                            torch.ones((1,), dtype=torch.int32))

    @pytest.mark.parametrize("device", ["cpu", "meta"])
    @pytest.mark.parametrize("fn", ["gather_pages", "scatter_pages"])
    def test_page_pack(self, one_rank_mesh, device, fn):
        pool = self._d(one_rank_mesh, torch.zeros((4, 8)), device)
        idx = torch.zeros((2,), dtype=torch.int32)
        args = (pool, idx) if fn == "gather_pages" \
            else (pool, idx, torch.zeros((2, 8)))
        with pytest.raises(TypeError, match="DTensor"):
            getattr(pack_ops, fn)(*args)

    @pytest.mark.parametrize("device", ["cpu", "meta"])
    def test_flash_attention(self, one_rank_mesh, device):
        q = torch.zeros((1, 8, 2, 16), device=device)
        kv = self._d(one_rank_mesh, torch.zeros((1, 8, 1, 16)), device)
        with pytest.raises(TypeError, match="DTensor"):
            fa_ops.flash_attention(q, kv, kv)


class TestFlashRoute:
    """One route per dtype: bf16 to the tensor-core kernels, f32 to the
    CUDA-core kernels, anything else raises (no route falls back to
    another)."""

    @pytest.mark.parametrize("D", fa_kernel.SUPPORTED_HEAD_DIMS)
    @pytest.mark.parametrize("dtype,entry", [
        (torch.bfloat16, ("repro_flash_attention_tc_fwd",
                          "repro_flash_attention_tc_bwd")),
        (torch.float32, ("repro_flash_attention_fwd",
                         "repro_flash_attention_bwd"))])
    def test_supported(self, dtype, entry, D):
        r = fa_kernel.route(dtype, D)
        assert (r.fwd, r.bwd) == entry

    @pytest.mark.parametrize("dtype,D", [
        (torch.float16, 128), (torch.float64, 64), (torch.bfloat16, 8),
        (torch.bfloat16, 72), (torch.float32, 256), (torch.float16, 72)])
    def test_unsupported_raises(self, dtype, D):
        with pytest.raises(ValueError):
            fa_kernel.route(dtype, D)


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
