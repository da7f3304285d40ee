"""What surrounds the bf16 flash backward of
``csrc/flash_attention_wgmma_bwd.cu`` (wgmma on tiles that TMA copies into
shared memory), on the CPU: the kernels themselves run only on the card,
where ``chip_smoke.py`` holds them against the plain version.

* each supported head dim runs the instance ``bwd_instance`` names (the
  forward's), the C dispatch agrees, and the tiles and passes are the
  ones the source states;
* the sources: the backward issues ``wgmma`` on operands that
  ``cp.async.bulk.tensor`` brought in under mbarriers, with
  ``setmaxnreg``; no bf16 flash source has ``mma.sync``, ``ldmatrix`` or
  an atomic; the Hopper helpers have one home (``hopper.cuh``);
* the tensor maps of o and dout for the model path's and the reference
  signature's views, and what ``bwd_operands`` hands the C entry: views
  read as they lie, the rest copied;
* the reference's backward through the binding's Python side: inputs in
  the reference signature's layout go through ``bwd_operands``, are read
  back through the strides it passes, and the plain backward of what is
  read equals ``jax.vjp`` of the reference's oracle (the twin of
  ``tests/test_torch_flash.py``'s backward tests).
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref
from repro.models.attention_ops import mha_reference as jax_mha_reference

from repro_torch.kernels._build import CSRC, SIGNATURES
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

BWD = CSRC / "flash_attention_wgmma_bwd.cu"
FWD = CSRC / "flash_attention_wgmma.cu"
HOPPER = CSRC / "hopper.cuh"
BF16 = torch.bfloat16
GRAD = dict(atol=1e-4, rtol=1e-4)
INSTANCE = {16: 64, 32: 64, 48: 64, 64: 64, 80: 128, 96: 128, 112: 128,
            128: 128, 192: 192}


def _code(path) -> str:
    """A source without its // comments."""
    return re.sub(r"//[^\n]*", "", path.read_text())


# ---------------------------------------------------------------- instances
class TestInstances:
    @pytest.mark.parametrize("D", fa.SUPPORTED_HEAD_DIMS)
    def test_each_head_dim_runs_the_forwards_instance(self, D):
        assert fa.bwd_instance(D) == INSTANCE[D] == fa.fwd_instance(D)
        assert fa.bwd_instance(D) % fa.WGMMA_ATOM == 0

    def test_the_c_dispatch_agrees(self):
        """``repro_flash_attention_tc_bwd``'s switch sends each head dim
        to the instance ``bwd_instance`` names, and no other."""
        body = _code(BWD).split("repro_flash_attention_tc_bwd(", 1)[1]
        cases, got = [], {}
        for tok in re.finditer(r"case (\d+):|bwd_launch<(\d+)>", body):
            if tok.group(1):
                cases.append(int(tok.group(1)))
            else:
                got.update(dict.fromkeys(cases, int(tok.group(2))))
                cases = []
        assert got == INSTANCE
        assert sorted(got) == sorted(fa.SUPPORTED_HEAD_DIMS)

    @pytest.mark.parametrize("D", fa.SUPPORTED_HEAD_DIMS)
    def test_tiles(self, D):
        """dQ: 128 query rows a block over 64-key tiles (32 at the 192
        instance); dK/dV: 128 keys a block over 64-row q tiles; wgmma's
        m64 a warpgroup."""
        code = _code(BWD)
        assert "static constexpr int kBK = D > 128 ? 32 : 64;" in code
        assert fa.bwd_dq_keys(D) == (32 if INSTANCE[D] > 128 else 64)
        assert f"constexpr int kBQ = {fa.BWD_DKDV_ROWS};" in code
        assert "constexpr int kWGRows = 64;" in code
        assert "constexpr int kRows = kConsumers * kWGRows;" in code
        assert 2 * 64 == fa.WGMMA_ROWS
        for n in (fa.bwd_dq_keys(D), fa.BWD_DKDV_ROWS):
            assert n % 16 == 0 and n <= 256     # k16 steps; a box's rows
        # O, copied in 128-row boxes, fills whole stages of K and V tiles
        assert fa.WGMMA_ROWS % (2 * fa.bwd_dq_keys(D)) == 0

    def test_two_passes_only_above_128(self):
        code = _code(BWD)
        assert "if constexpr (D > 128) {" in code
        assert code.count("dkdv_launch<D, kDvPass>") == 1
        assert code.count("dkdv_launch<D, kDkPass>") == 1
        assert code.count("dkdv_launch<D, kBothPass>") == 1

    def test_the_entry_takes_the_operands_strides(self):
        """Twelve (batch, seq, head) strides after D: q, k (and v), o,
        dout; the ctypes signature says the same."""
        sig = SIGNATURES["repro_flash_attention_tc_bwd"]
        assert len(sig) == 10 + 6 + 12 + 3 + 1
        head = _code(BWD).split('extern "C" int '
                                'repro_flash_attention_tc_bwd(', 1)[1]
        params = head.split(")", 1)[0]
        assert params.count("long long") == 12
        for name in ("sq_b", "sk_h", "so_s", "sd_h"):
            assert name in params
        assert fa.TENSOR_CORES.bwd == "repro_flash_attention_tc_bwd"


# ------------------------------------------------------------------ sources
HELPERS = ["smem_u32", "mbar_init", "mbar_arrive_expect_tx", "mbar_arrive",
           "mbar_wait", "tma_load", "tma_load_1d", "desc_sw128",
           "named_sync", "named_arrive", "wgmma_fence", "wgmma_commit",
           "wgmma_wait", "fence_regs", "pack_bf16", "exp2_approx",
           "setmaxnreg_dec", "setmaxnreg_inc", "my_turn", "your_turn",
           "issue_ss", "issue_rs", "pack_p", "encode_tiled", "tile_map",
           "vec_map", "allow_smem"]


class TestSources:
    def test_the_backward_is_wgmma_fed_by_tma(self):
        code = _code(BWD) + _code(HOPPER)
        assert '#include "hopper.cuh"' in BWD.read_text()
        for needle in ("wgmma.mma_async.sync.aligned.m64n", "wgmma.fence",
                       "wgmma.commit_group", "wgmma.wait_group",
                       "cp.async.bulk.tensor.4d", "cp.async.bulk.tensor.1d",
                       "mbarrier.try_wait", "mbarrier.arrive.expect_tx",
                       "setmaxnreg.dec", "setmaxnreg.inc",
                       "CU_TENSOR_MAP_SWIZZLE_128B"):
            assert needle in code, needle
        bwd = _code(BWD)
        for needle in ("flash_wgmma_bwd_dq(", "flash_wgmma_bwd_dkdv(",
                       "setmaxnreg_dec<kProducerRegs>()",
                       "setmaxnreg_inc<kConsumerRegs>()", "mbar_wait(",
                       "tma_load(", "tma_load_1d(", "issue_ss<", "issue_rs<",
                       "my_turn(wg)", "your_turn(wg)"):
            assert needle in bwd, needle

    @pytest.mark.parametrize("src", ["flash_attention_wgmma.cu",
                                     "flash_attention_wgmma_bwd.cu",
                                     "hopper.cuh", "flash_decode.cu"])
    @pytest.mark.parametrize("banned", ["mma.sync", "ldmatrix", "atomicAdd",
                                        "red."])
    def test_no_mma_sync_and_no_atomics_in_a_bf16_flash_source(self, src,
                                                               banned):
        assert banned not in _code(CSRC / src)

    def test_the_mma_sync_backward_is_gone(self):
        assert not (CSRC / "flash_attention_tc.cu").exists()
        assert not any("mma.sync" in _code(p) for p in CSRC.glob("flash_*"))

    @pytest.mark.parametrize("helper", HELPERS)
    def test_the_hopper_helpers_have_one_home(self, helper):
        """Among the bf16 flash sources (the other kernels keep their own
        copies of the few they use)."""
        pat = re.compile(rf"^(?:template <[^>]*>\s*)?(?:inline |__device__ "
                         rf"__forceinline__ )?\w+ {helper}\(", re.M)
        homes = [p.name for p in (FWD, BWD, HOPPER) if pat.search(_code(p))]
        assert homes == ["hopper.cuh"], homes

    @pytest.mark.parametrize("src", [FWD, BWD])
    def test_both_bf16_sources_include_the_helpers(self, src):
        text = src.read_text()
        assert '#include "hopper.cuh"' in text
        assert '#include "flash_mask.cuh"' in text

    def test_the_design_note(self):
        """The header states what bounds the kernel, what the design does
        about it and why the split recomputes S and dP."""
        head = BWD.read_text().split("#include", 1)[0]
        assert "What bounds it on this card: operations" in head
        assert "4.30e11 FLOP" in head
        assert "What the design does about it" in head
        assert "Why the split recomputes S and dP" in head
        assert "src/repro/kernels/flash_attention/flash_attention.py" in head

    def test_no_new_copy_of_the_masks(self):
        """The masks, ``k_range`` and ``floor_div`` are flash_mask.cuh's."""
        code = _code(BWD)
        for name in ("k_range(", "tile_full(", "row_pair_valid(",
                     "floor_div("):
            assert name in code
        assert "__forceinline__ bool" not in code
        assert "__forceinline__ int floor_div" not in code


# ------------------------------------------------------ maps and operands
def _fused(B=2, S=300, H=8, KVH=2, D=128):
    qkv = torch.zeros((B, S, H + 2 * KVH, D), dtype=BF16)
    return qkv.split([H, KVH, KVH], dim=2)


def _reference(B=2, H=8, KVH=2, S=100, D=64):
    """q, k, v, o, dout in the reference signature's (B, H, S, D) layout,
    viewed in the model layout."""
    q, o, dout = (torch.zeros((B, H, S, D), dtype=BF16).transpose(1, 2)
                  for _ in range(3))
    k, v = (torch.zeros((B, KVH, S, D), dtype=BF16).transpose(1, 2)
            for _ in range(2))
    return q, k, v, o, dout


class TestOperands:
    def test_o_and_dout_maps_of_the_model_path(self):
        """o comes contiguous from the forward; dout as autograd gives it,
        contiguous or a view of a fused projection's gradient."""
        B, S, H, D = 2, 300, 8, 128
        o = torch.zeros((B, S, H, D), dtype=BF16)
        m = fa.tensor_map(o, fa.WGMMA_ROWS)
        assert m == fa.TensorMap((D, H, S, B), (D * 2, H * D * 2,
                                                S * H * D * 2),
                                 (64, 1, 128, 1))
        dout = _fused(B, S, H, 2, D)[0]
        md = fa.tensor_map(dout, fa.BWD_DKDV_ROWS)
        row = (H + 4) * D * 2
        assert md.dims == (D, H, S, B)
        assert md.strides == (D * 2, row, S * row)
        assert md.box == (64, 1, 64, 1)

    def test_o_and_dout_maps_of_the_reference_signature(self):
        B, H, S, D = 2, 8, 100, 64
        *_, o, dout = _reference(B, H, 2, S, D)
        for t in (o, dout):
            m = fa.tensor_map(t, fa.WGMMA_ROWS)
            assert m.dims == (D, H, S, B)
            assert m.strides == (S * D * 2, D * 2, H * S * D * 2)
            assert all(s % 16 == 0 for s in m.strides)

    @pytest.mark.parametrize("layout", ["contiguous", "fused", "reference"])
    def test_views_reach_the_backward_uncopied(self, layout):
        if layout == "contiguous":
            q, o, dout = (torch.zeros((2, 50, 8, 64), dtype=BF16)
                          for _ in range(3))
            k, v = (torch.zeros((2, 50, 2, 64), dtype=BF16)
                    for _ in range(2))
        elif layout == "fused":
            q, k, v = _fused(D=64)
            o, dout = torch.zeros_like(q), _fused(D=64)[0]
        else:
            q, k, v, o, dout = _reference()
        lse = torch.zeros((2, 8, q.shape[1]), dtype=torch.float32)
        got = fa.bwd_operands(q, k, v, o, lse, dout)
        for a, b in zip(got[:6], (q, k, v, o, lse, dout)):
            assert a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
        assert got[6] == (*q.stride()[:3], *k.stride()[:3],
                          *o.stride()[:3], *dout.stride()[:3])

    def test_what_rows_aligned_refuses_is_copied(self):
        wide = torch.zeros((2, 9, 4, 68), dtype=BF16)[..., :64]
        q = wide
        k, v = (torch.zeros((2, 9, 2, 64), dtype=BF16) for _ in range(2))
        lse = torch.zeros((2, 4, 9), dtype=torch.float32)
        got = fa.bwd_operands(q, k, v, q, lse, q)
        for t in (got[0], got[3], got[5]):
            assert t.is_contiguous() and t.data_ptr() != q.data_ptr()
        assert got[1].data_ptr() == k.data_ptr()

    def test_k_and_v_with_other_strides_are_both_copied(self):
        k = torch.zeros((2, 9, 2, 64), dtype=BF16)
        v = torch.zeros((2, 2, 9, 64), dtype=BF16).transpose(1, 2)
        q = torch.zeros((2, 9, 4, 64), dtype=BF16)
        lse = torch.zeros((2, 4, 9), dtype=torch.float32)
        _, k2, v2, *_ = fa.bwd_operands(q, k, v, q, lse, q)
        assert k2.stride() == v2.stride() == k.stride()
        assert v2.data_ptr() != v.data_ptr()

    def test_an_unaligned_lse_is_cloned(self):
        flat = torch.zeros(2 * 4 * 9 + 1, dtype=torch.float32)
        lse = flat[1:].view(2, 4, 9)
        assert lse.data_ptr() % 16 == 4
        q = torch.zeros((2, 9, 4, 64), dtype=BF16)
        k = torch.zeros((2, 9, 2, 64), dtype=BF16)
        got = fa.bwd_operands(q, k, k, q, lse, q)[4]
        assert got.data_ptr() % 16 == 0 and torch.equal(got, lse)

    def test_the_f32_route_makes_everything_contiguous(self):
        """No longer: the f32 route reads its strided views as they lie,
        under bf16's rule, with the same strides in the C entry's order."""
        q, k, v, o, dout = (t.float() for t in _reference())
        lse = torch.zeros((2, 8, 100), dtype=torch.float32)
        got = fa.bwd_operands(q, k, v, o, lse, dout)
        assert not q.is_contiguous()
        for t, g in zip((q, k, v, o, dout), got[:3] + got[3:4] + got[5:6]):
            assert g.data_ptr() == t.data_ptr() and g.stride() == t.stride()
        assert got[6] == (*q.stride()[:3], *k.stride()[:3], *o.stride()[:3],
                          *dout.stride()[:3])


# --------------------------------------- the reference through the binding
def _read_as_the_kernel(t, strides):
    """The (B, S, heads, D) tensor the kernel reads from ``t``'s storage
    through the (batch, seq, head) element strides it is passed."""
    return torch.as_strided(t, t.shape, (*strides, 1), t.storage_offset())


def _through_the_binding(q, k, v, o, dout, lse):
    """What the C entry receives for model-layout operands, read back."""
    qq, kk, vv, oo, ll, dd, strides = fa.bwd_operands(q, k, v, o, lse, dout)
    sq, sk, so, sd = (strides[i:i + 3] for i in range(0, 12, 3))
    return (_read_as_the_kernel(qq, sq), _read_as_the_kernel(kk, sk),
            _read_as_the_kernel(vv, sk), _read_as_the_kernel(oo, so),
            _read_as_the_kernel(dd, sd), ll)


def _inputs(B, S, H, KVH, D, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sk or S
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, H, S, D), f(B, KVH, Sk, D), f(B, KVH, Sk, D), f(B, H, S, D)


class TestReferenceThroughTheBinding:
    """The plain backward of what the binding hands the kernel, given the
    reference signature's (B, H, S, D) tensors as model-layout views,
    against ``jax.vjp`` of the reference (``tests/test_torch_flash.py``'s
    cases)."""

    @pytest.mark.parametrize("S,H,KVH,causal,window", [
        (37, 4, 4, True, 0),
        (40, 10, 2, True, 0),       # a group of 5 query heads
        (40, 10, 2, True, 9),       # sliding window
        (24, 4, 2, False, 0),       # non-causal
    ])
    def test_backward_matches_reference_vjp(self, S, H, KVH, causal, window):
        q, k, v, cot = _inputs(2, S, H, KVH, 16, seed=7)
        kw = dict(causal=causal, window=window)
        _, vjp = jax.vjp(lambda q, k, v: jax_flash_ref(q, k, v, **kw),
                         *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(cot))
        tq, tk, tv, tc = (torch.from_numpy(x) for x in (q, k, v, cot))
        o = flash_attention_ref(tq, tk, tv, **kw)
        lse = torch.zeros((2, H, S), dtype=torch.float32)
        views = [t.transpose(1, 2) for t in (tq, tk, tv, o, tc)]
        rq, rk, rv, ro, rd, _ = _through_the_binding(*views, lse)
        for a, b in zip((rq, rk, rv, ro, rd), views):
            assert a.data_ptr() == b.data_ptr() and torch.equal(a, b)
        got = flash_attention_bwd_ref(*(t.transpose(1, 2)
                                        for t in (rq, rk, rv, ro, rd)), **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)

    @pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2)])
    def test_head_dim_192(self, H, KVH):
        q, k, v, cot = _inputs(1, 33, H, KVH, 192, seed=12)
        _, vjp = jax.vjp(lambda q, k, v: jax_flash_ref(q, k, v, causal=True),
                         *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(cot))
        tq, tk, tv, tc = (torch.from_numpy(x) for x in (q, k, v, cot))
        o = flash_attention_ref(tq, tk, tv)
        lse = torch.zeros((1, H, 33), dtype=torch.float32)
        read = _through_the_binding(*(t.transpose(1, 2)
                                      for t in (tq, tk, tv, o, tc)), lse)
        got = flash_attention_bwd_ref(*(t.transpose(1, 2)
                                        for t in read[:5]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)

    @pytest.mark.parametrize("Sq,Sk", [(1, 17), (5, 40), (33, 1)])
    def test_cross_attention(self, Sq, Sk):
        """Sq != Sk without a mask (the encoder-decoder family's cross
        attention), against ``jax.vjp`` of ``mha_reference``."""
        q, k, v, cot = _inputs(2, Sq, 4, 2, 16, seed=11, Sk=Sk)
        ml = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))  # noqa
        _, vjp = jax.vjp(
            lambda q, k, v: jax_mha_reference(q, k, v, causal=False),
            *(jnp.asarray(ml(x)) for x in (q, k, v)))
        want = vjp(jnp.asarray(ml(cot)))
        tq, tk, tv, tc = (torch.from_numpy(x) for x in (q, k, v, cot))
        o = flash_attention_ref(tq, tk, tv, causal=False)
        lse = torch.zeros((2, 4, Sq), dtype=torch.float32)
        read = _through_the_binding(*(t.transpose(1, 2)
                                      for t in (tq, tk, tv, o, tc)), lse)
        got = flash_attention_bwd_ref(*(t.transpose(1, 2)
                                        for t in read[:5]), causal=False)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.transpose(1, 2).numpy(),
                                       np.asarray(w), **GRAD)
