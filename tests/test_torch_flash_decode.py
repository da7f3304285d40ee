"""Port vs reference, flash attention's few-row forward and the f32
backward's layout of work: the plain models of two kernels' arithmetic
(``kernels/flash_attention/ref.py``) against the reference, and the pure
functions that pick the decode kernel and its cluster size.

* ``flash_attention_split_ref`` — the decode kernel's split of the keys
  into N shares and its combine in rank order — gives the reference's o
  (``repro.models.attention_ops.flash_attention_xla``) and its lse (the
  logsumexp of the same masked, scaled scores, in ``jax.numpy``) at every
  N, shares empty under a window, a causal mask or a query offset;
* ``flash_attention_dkdv_by_head_ref`` — dK, dV as one term a query head,
  added in head order, as the re-gridded f32 backward forms them — equals
  the reference's VJP at G = 1, 3 and 12;
* ``forward_entry`` sends Whisper's decode to the decode kernel and every
  training and sequence-split shape to the tile kernels; ``decode_plan``
  fills the card or stops at the largest cluster.

Inputs come from numpy with a seed.  Tolerances: f32 2e-5 (the bound of
``tests/test_kernels.py::_tol``); integer results exact.  The CUDA kernels
themselves run on the card only (``chip_smoke.py``, ``tools/
flash_decode_sweep.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention_ops import flash_attention_xla as jax_flash_xla

from repro_torch import kernels as tk
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_dkdv_by_head_ref, flash_attention_split_ref,
    split_shares)

F32 = dict(atol=2e-5, rtol=2e-5)
SPLITS = (1, 2, 4, 8, 16)
TILES = sorted(set(fa.DECODE_TILE_ROWS.values()))   # the f32, bf16 stages


def _inputs(B, Sq, Sk, H, KVH, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, D)).astype(np.float32))


def _jax_lse(q, k, causal, window, q_offset):
    """The reference's masked, scaled scores' logsumexp: (B, H, Sq)."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    kf = jnp.repeat(k, H // KVH, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, kf) / np.sqrt(D)
    qp = q_offset + jnp.arange(Sq)[:, None]
    kp = jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    return jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1)


def _kl(t):          # model layout (B, S, H, D) -> kernel layout (B, H, S, D)
    return torch.from_numpy(t).transpose(1, 2)


# B, Sq, Sk, H, KVH, D, causal, window, q_offset: Sq 1 / 3 / 8, G 1 / 4,
# D 64 / 128
SPLIT_CASES = [
    (2, 1, 150, 4, 4, 64, False, 0, 0),       # Whisper's decode, narrow
    (1, 1, 200, 8, 2, 128, False, 37, 180),   # one row, window, offset
    (2, 3, 190, 4, 1, 64, True, 0, 120),      # causal at an offset
    (1, 3, 170, 4, 4, 128, False, 0, 0),      # few rows, unmasked
    (1, 8, 260, 8, 2, 64, True, 50, 200),     # causal window at an offset
    (2, 8, 96, 4, 4, 128, True, 0, 88),       # the last rows of a sequence
]


class TestSplitCombine:
    """The decode kernel's arithmetic, share by share, against the
    reference's chunked flash attention."""

    @pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,causal,window,q_offset",
                             SPLIT_CASES)
    def test_every_split_gives_the_reference(self, B, Sq, Sk, H, KVH, D,
                                             causal, window, q_offset):
        q, k, v = _inputs(B, Sq, Sk, H, KVH, D, seed=Sq * 10 + D)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        want_o = np.asarray(jax.jit(lambda q, k, v: jax_flash_xla(
            q, k, v, **kw))(q, k, v))
        want_lse = np.asarray(jax.jit(lambda q, k: _jax_lse(
            q, k, causal, window, q_offset))(q, k))
        for tile in TILES:
            for n in SPLITS:
                o, lse = flash_attention_split_ref(
                    _kl(q), _kl(k), _kl(v), n_splits=n, tile=tile, **kw)
                np.testing.assert_allclose(o.transpose(1, 2).numpy(),
                                           want_o, **F32)
                np.testing.assert_allclose(lse.numpy(), want_lse, **F32)

    @pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,causal,window,q_offset",
                             SPLIT_CASES)
    def test_shares_cover_the_visible_keys_once(self, B, Sq, Sk, H, KVH, D,
                                                causal, window, q_offset):
        """The shares are consecutive, in rank order, and cover exactly
        the tiles of the keys the rows see; at 16 shares a masked case
        leaves some empty."""
        end = min(Sk, q_offset + Sq) if causal else Sk
        first = max(0, q_offset - window + 1) if window > 0 else 0
        for tile in TILES:
            for n in SPLITS:
                shares = split_shares(Sq, Sk, causal, window, q_offset, n,
                                      tile)
                assert len(shares) == n
                assert shares[0][0] == first // tile * tile
                assert shares[-1][1] == min(Sk, -(-end // tile) * tile)
                for (lo, hi), (lo2, _) in zip(shares, shares[1:]):
                    assert lo <= hi == lo2
            if causal or window:
                assert any(lo == hi for lo, hi in split_shares(
                    Sq, Sk, causal, window, q_offset, 16, tile))


class TestDkdvByHead:
    """The re-gridded f32 backward's dK, dV: one term a query head, added
    in head order, against the reference's VJP."""

    @pytest.mark.parametrize("G", [1, 3, 12])
    @pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
        (40, 40, True, 0, 0),              # causal
        (40, 40, True, 9, 0),              # causal window
        (24, 64, True, 0, 40),             # a rank's rows at an offset
        (16, 48, False, 7, 20),            # window at an offset, non-causal
    ])
    def test_matches_reference_vjp(self, G, Sq, Sk, causal, window,
                                   q_offset):
        KVH, D = 2, 16
        H = G * KVH
        q, k, v = _inputs(1, Sq, Sk, H, KVH, D, seed=G + Sq)
        cot = np.random.default_rng(G).standard_normal(q.shape).astype(
            np.float32)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        o, vjp = jax.vjp(jax.jit(lambda q, k, v: jax_flash_xla(q, k, v,
                                                               **kw)),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        _, want_dk, want_dv = vjp(jnp.asarray(cot))
        dk, dv = flash_attention_dkdv_by_head_ref(
            _kl(q), _kl(k), _kl(v), _kl(np.array(o)), _kl(cot), **kw)
        np.testing.assert_allclose(dk.transpose(1, 2).numpy(),
                                   np.asarray(want_dk), **F32)
        np.testing.assert_allclose(dv.transpose(1, 2).numpy(),
                                   np.asarray(want_dv), **F32)


def _seq_split_rows(arch: str) -> int:
    """A rank's query rows under the chip run's 16-rank sequence split."""
    seq = {"mixtral_8x7b": 8192, "starcoder2_3b": 1536}.get(arch, 4096)
    return seq // 16


class TestForwardEntry:
    """The forward's kernel, from shapes alone."""

    def test_whisper_decode_takes_the_decode_kernel(self):
        c = get_config("whisper_medium")
        for dt in (torch.bfloat16, torch.float32):
            assert fa.forward_entry(dt, c.head_dim, 1) == fa.DECODE

    @pytest.mark.parametrize("arch", ARCH_IDS)
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_training_and_split_shapes_keep_the_tile_kernels(self, arch,
                                                             dtype):
        c = get_config(arch)
        D = 192 if arch == "deepseek_v3_671b" else c.head_dim
        want = fa.route(dtype, D).fwd
        rows = [4096, _seq_split_rows(arch)]
        if arch == "whisper_medium":                 # cross 448, encoder
            rows += [c.max_target_positions, c.max_source_positions]
        for Sq in rows:
            assert fa.forward_entry(dtype, D, Sq) == want

    def test_threshold_is_the_constant(self):
        assert fa.DECODE_MAX_ROWS == 8
        assert fa.forward_entry(torch.bfloat16, 64, 8) == fa.DECODE
        assert fa.forward_entry(torch.bfloat16, 64, 9) == \
            fa.TENSOR_CORES.fwd
        assert fa.forward_entry(torch.float32, 64, 9) == fa.F32.fwd

    @pytest.mark.parametrize("dtype,D", [(torch.float16, 64),
                                         (torch.bfloat16, 72)])
    def test_refuses_what_no_kernel_takes(self, dtype, D):
        with pytest.raises(ValueError):
            fa.forward_entry(dtype, D, 1)


class TestDecodePlan:
    """``decode_plan`` and the integer helpers beside it: exact."""

    def test_fills_the_card(self):
        # Whisper's decode at B = 4: 64 clusters; 2 x 64 < 132 SMs
        n = fa.decode_plan(64, 24, 132, active_clusters=lambda n: 99)
        assert n == 4 and 64 * n >= 132 and 64 * (n // 2) < 132

    def test_stops_at_the_largest_cluster(self):
        # batch 1: 16 clusters of 8 still leave SMs idle
        assert fa.decode_plan(16, 24, 132, active_clusters=lambda n: 99) \
            == fa.MAX_CLUSTER

    def test_stops_where_clusters_would_not_fit_at_once(self):
        fit = {2: 64, 4: 32, 8: 16}
        assert fa.decode_plan(64, 24, 132,
                              active_clusters=fit.__getitem__) == 2

    def test_stops_at_the_key_tiles(self):
        assert fa.decode_plan(4, 3, 132, active_clusters=lambda n: 99) == 2
        assert fa.decode_plan(4, 1, 132, active_clusters=lambda n: 99) == 1

    def test_one_block_where_the_clusters_fill_the_card(self):
        assert fa.decode_plan(132, 24, 132,
                              active_clusters=lambda n: 999) == 1

    @pytest.mark.parametrize("Sq,Sk,causal,window,q_offset,tile,want", [
        (1, 1500, False, 0, None, 64, 24),
        (1, 1500, False, 0, None, 32, 47),
        (3, 700, True, 0, 697, 64, 11),
        (8, 900, True, 100, 300, 64, 2),      # keys 201 .. 307
        (7, 5, False, 0, None, 64, 1),
    ])
    def test_decode_tiles(self, Sq, Sk, causal, window, q_offset, tile,
                          want):
        assert fa.decode_tiles(Sq, Sk, causal, window, q_offset, tile) == want

    @pytest.mark.parametrize("rows,D,want_f32,want_bf16", [
        (1, 64, 1, 1), (2, 64, 2, 2), (3, 64, 4, 4), (5, 64, 8, 4),
        (96, 64, 8, 4), (1, 128, 1, 1), (3, 128, 4, 2), (4, 128, 4, 2),
        (12, 128, 4, 2), (60, 192, 4, 2), (8, 48, 8, 4)])
    def test_rows_per_block(self, rows, D, want_f32, want_bf16):
        assert fa.decode_rows_per_block(rows, D, torch.float32) == want_f32
        assert fa.decode_rows_per_block(rows, D, torch.bfloat16) == \
            want_bf16


def test_plain_route_counts_no_decode_launch():
    """A CPU call takes the plain version: no counter moves, the decode
    route's, the bf16 forward route's and the f32 route's included."""
    tk.reset_launch_counts()
    q = torch.zeros((2, 1, 4, 64), requires_grad=True)
    kv = torch.zeros((2, 30, 4, 64))
    flash_attention(q, kv, kv, causal=False).sum().backward()
    assert tk.route_launch_counts() == {"flash_decode": 0,
                                        "flash_wgmma_fwd": 0,
                                        "flash_f32_fwd": 0,
                                        "flash_f32_bwd": 0}
    assert not any(tk.launch_counts().values())
