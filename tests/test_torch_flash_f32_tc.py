"""The f32 flash route of ``csrc/flash_attention.cu`` (3xTF32 on wgmma, tiles
fed by TMA), on the CPU: the kernels run only on the card, where
``chip_smoke.py`` holds them against the plain version.

* the arithmetic: an emulation of error-compensated TF32 (each operand
  rounded to TF32 on its int32 view, split into big and small parts, three
  products summed in f32) keeps the f32 attention forward and its
  gradients within chip_smoke's f32 tolerances (2e-5 forward, 1e-4
  gradients, atol = rtol) of the f32 plain version at chip_smoke's small
  cases, and one TF32 product does not;
* the instance map, each instance's tiles as the source states them, and
  the shared memory each kernel asks (at most 232,448 bytes);
* the f32 tensor maps (a box of one 32-column atom) and the backward's
  operands read through their strides as they lie;
* the source: wgmma on TF32 operands, TMA copies, no FFMA loop left.
"""

from __future__ import annotations

import math
import re

import pytest
import torch

import chip_smoke
from repro_torch.kernels._build import CSRC, SIGNATURES
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ref import (_mask,
                                                     flash_attention_ref)

F32 = torch.float32
SRC = CSRC / "flash_attention.cu"
HOPPER = CSRC / "hopper.cuh"
TOL_FWD = chip_smoke.TOL["float32"]
TOL_GRAD = chip_smoke.GRAD_TOL_F32


def _code(path) -> str:
    """A source without its // comments."""
    return re.sub(r"//[^\n]*", "", path.read_text())


# --------------------------------------------------------------- arithmetic
def _tf32(x, rounded=True):
    """x rounded to TF32 on its int32 view, to nearest with ties away from
    zero (``cvt.rna.tf32.f32``; the kernels' ``tf32_rna``), or (not
    ``rounded``) its low 13 mantissa bits cleared, as a tensor core that
    reads only a TF32 operand's top 19 bits takes it."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = ((u + 0x1000) if rounded else u) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(F32).view(x.shape)


def _split(x, rounded=True):
    """``split_tf32``: big = x rounded to TF32, small = the rest (exact)
    rounded again, or (not ``rounded``) left for the tensor core to
    truncate."""
    big = _tf32(x)
    return big, _tf32(x - big, rounded)


def _mm3(a, b, rounded=True):
    """a @ b as the kernels take it: three TF32 products, f32 sums."""
    ab, a_s = _split(a, rounded)
    bb, b_s = _split(b, rounded)
    return a_s @ bb + ab @ b_s + ab @ bb


def _mm3_small_truncated(a, b):
    return _mm3(a, b, rounded=False)


def _mm1(a, b):
    """a @ b as one TF32 product."""
    return _tf32(a) @ _tf32(b)


def _attention(q, k, v, do, causal, window, q_offset, mm):
    """Forward and gradients of attention with every product taken by
    ``mm``, f32, as the kernels form them (q, do (B, H, Sq, D); k, v
    (B, KVH, Sk, D)): o, dq, dk, dv."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = H // KVH
    kr, vr = (t.repeat_interleave(G, dim=1) for t in (k, v))
    scale = 1.0 / math.sqrt(D)
    s = mm(q, kr.transpose(-1, -2)) * scale
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    s = torch.where(mask, s, torch.full_like(s, fa.NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = mm(p, vr)
    dv = mm(p.transpose(-1, -2), do)
    dp = mm(do, vr.transpose(-1, -2))
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    dq = mm(ds, kr) * scale
    dk = mm(ds.transpose(-1, -2), q) * scale
    dk, dv = (t.reshape(B, KVH, G, Sk, D).sum(2) for t in (dk, dv))
    return o, dq, dk, dv


def _plain(q, k, v, do, causal, window, q_offset):
    """The f32 plain version and its autograd, as chip_smoke compares."""
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention_ref(q, k, v, causal=causal, window=window,
                            q_offset=q_offset)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


def _within(a, b, tol) -> bool:
    """chip_smoke's check_close: |a - b| <= tol + tol |b| everywhere."""
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def _inputs(B, Sq, Sk, H, KVH, D, seed):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((B, H, Sq, D), generator=g) for _ in range(2))
    k, v = (torch.randn((B, KVH, Sk, D), generator=g) for _ in range(2))
    return q, k, v, do


# chip_smoke's small f32 cases (FLASH_CASES, the f32 route's own edges
# F32_EDGE_CASES and the training example's call), at most 200 rows here:
# B, Sq, Sk, H, KVH, D, causal, window, q_offset
CASES = [(B, S, S, H, KVH, D, c, w, None)
         for B, S, H, KVH, D, c, w, *_ in chip_smoke.FLASH_CASES
         if S <= 200] \
    + [tuple(c[:9]) for c in chip_smoke.F32_EDGE_CASES if c[1] <= 200] \
    + [(B, S, S, H, KVH, D, True, 0, None)
       for B, S, H, KVH, D in [chip_smoke.EXAMPLE_F32]]


class TestArithmetic:
    @pytest.mark.parametrize("mm", [_mm3, _mm3_small_truncated],
                             ids=["kernels", "small_truncated"])
    @pytest.mark.parametrize("case", CASES, ids=str)
    def test_three_tf32_products_hold_the_f32_tolerances(self, case, mm):
        """As the kernels split, and with the small part left unrounded
        for the tensor core to truncate."""
        B, Sq, Sk, H, KVH, D, causal, window, q_offset = case
        q, k, v, do = _inputs(B, Sq, Sk, H, KVH, D, seed=Sq + D)
        off = q_offset or 0
        got = _attention(q, k, v, do, causal, window, off, mm)
        want = _plain(q, k, v, do, causal, window, off)
        assert _within(got[0], want[0], TOL_FWD)
        for a, b in zip(got[1:], want[1:]):
            assert _within(a, b, TOL_GRAD)

    @pytest.mark.parametrize("case", CASES[:3], ids=str)
    def test_one_tf32_product_does_not(self, case):
        B, Sq, Sk, H, KVH, D, causal, window, q_offset = case
        q, k, v, do = _inputs(B, Sq, Sk, H, KVH, D, seed=Sq + D)
        off = q_offset or 0
        got = _attention(q, k, v, do, causal, window, off, _mm1)
        want = _plain(q, k, v, do, causal, window, off)
        assert not _within(got[0], want[0], TOL_FWD)
        assert not all(_within(a, b, TOL_GRAD)
                       for a, b in zip(got[1:], want[1:]))

    @pytest.mark.parametrize("rounded", [False, True])
    def test_the_split_keeps_22_bits(self, rounded):
        x = torch.randn(100_000, generator=torch.Generator().manual_seed(1))
        big, small = _split(x, rounded)
        bits = torch.stack([big, small]).view(torch.int32)
        assert not bool((bits & 0x1FFF).any())          # both TF32 values
        assert bool(((big + small - x).abs() <= 2.0 ** -21 * x.abs()).all())
        assert not bool(((big - x).abs() <= 2.0 ** -14 * x.abs()).all())

    def test_truncation_and_rounding(self):
        one = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                            -(1.0 + 3 * 2.0 ** -12)])
        assert _tf32(one).tolist() == [
            1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
        assert _tf32(one, rounded=False).tolist() == [1.0, 1.0, -1.0]

    def test_the_kernels_split_as_emulated(self):
        code = _code(HOPPER)
        rna = code.split("uint32_t tf32_rna(", 1)[1].split("}", 1)[0]
        assert "return (bits + 0x1000u) & 0xffffe000u;" in rna
        body = code.split("void split_tf32(", 1)[1].split("}", 1)[0]
        assert "big = tf32_rna(__float_as_uint(x));" in body
        assert ("small = tf32_rna(__float_as_uint(x - __uint_as_float(big)));"
                in body)
        body = code.split("void mma3_k8(", 1)[1].split("}", 1)[0]
        assert body.count("wgmma_tf32<N>(") == 3
        for pair in ("a_small, desc_k8<N>(b_big", "a_big, desc_k8<N>(b_small",
                     "a_big, desc_k8<N>(b_big"):
            assert pair in body


# ---------------------------------------------------- instances and tiles
INSTANCE = {16: 64, 32: 64, 48: 64, 64: 64, 80: 128, 96: 128, 112: 128,
            128: 128, 192: 192}


def _source_tiles() -> dict:
    """REPRO_F32_TILES of the source: instance -> (forward keys, dQ keys,
    dK/dV query rows)."""
    code = SRC.read_text()
    table = code.split("#define REPRO_F32_TILES(X)", 1)[1].split("\n\n", 1)[0]
    return {int(m[0]): tuple(int(x) for x in m[1:])
            for m in re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", table)}


class TestInstances:
    @pytest.mark.parametrize("D", fa.SUPPORTED_HEAD_DIMS)
    def test_each_head_dim_runs_its_instance(self, D):
        assert fa.f32_instance(D) == INSTANCE[D]
        assert fa.f32_instance(D) % fa.F32_ATOM == 0

    def test_the_c_dispatch_agrees(self):
        body = _code(SRC).split("int instance(int D) {", 1)[1]
        body = body.split("default:", 1)[0]
        got = {}
        for line in body.splitlines():
            heads = [int(x) for x in re.findall(r"case (\d+):", line)]
            ret = re.search(r"return (\d+);", line)
            if heads:
                got.update(dict.fromkeys(heads, int(ret.group(1))))
        assert got == INSTANCE

    def test_the_tiles_are_the_sources(self):
        assert _source_tiles() == fa.F32_TILES
        assert sorted(fa.F32_TILES) == sorted(set(INSTANCE.values()))

    @pytest.mark.parametrize("D", [64, 128, 192])
    def test_tiles_are_whole_atoms(self, D):
        assert all(t % fa.F32_ATOM == 0 for t in fa.F32_TILES[D])

    def test_the_mirror_takes_the_sources_constants(self):
        code = _code(SRC)
        for needle in ("constexpr int kRows = 64;",
                       "constexpr int kMaxStages = 4;",
                       "constexpr int kReserve = 1024 + 128;",
                       "kRing + kStages * 2 * kKVBytes",
                       "kBars + (1 + 2 * kStages) * 8 + 1024",
                       "1 + (kDk ? 1 : 0) + (kDv ? 2 : 0)\n" + " " * 32
                       + "+ (kDk && kDv ? 2 : 0)",
                       "2 * kQBytes + 2 * kStatBytes",
                       "(kStatBox * 4 + 127) / 128 * 128"):
            assert needle in code, needle
        assert fa.MAX_SHARED_BYTES == 232448 == int(re.search(
            r"kMaxSharedBytes = (\d+);", _code(HOPPER)).group(1))

    @pytest.mark.parametrize("kernel,D,pass_", [
        ("fwd", 64, "both"), ("fwd", 128, "both"), ("fwd", 192, "both"),
        ("dq", 64, "both"), ("dq", 128, "both"), ("dq", 192, "both"),
        ("dkdv", 64, "both"), ("dkdv", 128, "both"), ("dkdv", 192, "dv"),
        ("dkdv", 192, "dk")])
    def test_each_kernel_fits_a_block(self, kernel, D, pass_):
        assert fa.f32_smem_bytes(kernel, D, pass_) <= fa.MAX_SHARED_BYTES

    def test_the_instances_stages(self):
        """What the header states: the forward's ring at D = 64, 128, 192
        is 4, 1, 1 stages (Q split once at 64); dQ's 4, 2, 1 (Q and dO
        split once at 64 and 128); dK/dV's 2, 2 and 1 a pass."""
        def stages(kernel, D, p="both"):
            fwd_keys, dq_keys, rows = fa.F32_TILES[D]
            q = fa.F32_ROWS * D * 4
            if kernel == "fwd":           # Q split once where it fits
                kv = fwd_keys * D * 4
                pre = (fa.MAX_SHARED_BYTES - 2 * q - 4 * kv - 1152) \
                    // (2 * kv) >= 1
                fixed, stage = (2 if pre else 1) * q + 4 * kv, 2 * kv
            elif kernel == "dq":          # Q, dO split once where it fits
                kv = dq_keys * D * 4
                pre = (fa.MAX_SHARED_BYTES - 4 * q - 2 * kv - 1152) \
                    // (2 * kv) >= 2
                fixed, stage = (4 if pre else 2) * q + 2 * kv, 2 * kv
            else:
                dv, dk = p != "dk", p != "dv"
                qt = rows * D * 4
                stat = ((rows + 4) * 4 + 127) // 128 * 128
                fixed = 2 * q + (1 + dk + 2 * dv + 2 * (dk and dv)) * qt
                stage = 2 * qt + 2 * stat
            return min(4, (fa.MAX_SHARED_BYTES - fixed - 1152) // stage)
        assert [stages("fwd", d) for d in (64, 128, 192)] == [4, 1, 1]
        assert [stages("dq", d) for d in (64, 128, 192)] == [4, 2, 1]
        assert [stages("dkdv", 64), stages("dkdv", 128),
                stages("dkdv", 192, "dv"), stages("dkdv", 192, "dk")] \
            == [2, 2, 1, 1]

    def test_the_192_instance_takes_two_passes(self):
        code = _code(SRC)
        assert "if constexpr (D > 128) {" in code
        assert "dkdv_launch<D, kDvPass>" in code
        assert "dkdv_launch<D, kDkPass>" in code
        with pytest.raises(ValueError, match="no stage fits"):
            fa.f32_smem_bytes("dkdv", 192, "both")


# ------------------------------------------------------------- tensor maps
class TestTensorMap:
    def test_contiguous(self):
        B, S, H, D = 2, 300, 8, 128
        t = torch.zeros((B, S, H, D), dtype=F32)
        m = fa.tensor_map(t, fa.F32_ROWS)
        assert m == fa.TensorMap((D, H, S, B),
                                 (D * 4, H * D * 4, S * H * D * 4),
                                 (32, 1, 64, 1))

    @pytest.mark.parametrize("rows", [32, 64])
    def test_the_box_is_one_atom_of_the_tiles_rows(self, rows):
        t = torch.zeros((1, 100, 2, 64), dtype=F32)
        assert fa.tensor_map(t, rows).box == (fa.F32_ATOM, 1, rows, 1)
        assert fa.F32_ATOM * 4 == 128

    def test_model_path_views_of_a_fused_projection(self):
        B, S, H, KVH, D = 2, 300, 10, 2, 128
        qkv = torch.zeros((B, S, H + 2 * KVH, D), dtype=F32)
        q, k, _ = qkv.split([H, KVH, KVH], dim=2)
        row = (H + 2 * KVH) * D * 4
        assert fa.tensor_map(q, 64) == fa.TensorMap(
            (D, H, S, B), (D * 4, row, S * row), (32, 1, 64, 1))
        assert fa.tensor_map(k, 32).dims == (D, KVH, S, B)
        assert fa.tensor_map(k, 32).strides == (D * 4, row, S * row)

    def test_reference_signature_views(self):
        B, H, S, D = 2, 8, 100, 64
        q = torch.zeros((B, H, S, D), dtype=F32).transpose(1, 2)
        m = fa.tensor_map(q, 64)
        assert m.dims == (D, H, S, B)
        assert m.strides == (S * D * 4, D * 4, H * S * D * 4)

    def test_a_dim_of_one_gets_a_valid_stride(self):
        t = torch.zeros((1, 50, 1, 80), dtype=F32)
        m = fa.tensor_map(t, 64)
        assert m.strides == (80 * 4, 80 * 4, 50 * 80 * 4)

    def test_the_padded_columns_are_zero_filled(self):
        """A head dim under its instance: the map carries the true head dim
        (the copy zero-fills past it), and the source's maps are f32 with
        the 128-byte swizzle."""
        t = torch.zeros((1, 50, 2, 80), dtype=F32)
        assert fa.tensor_map(t, 64).dims[0] == 80 < fa.f32_instance(80)
        code = _code(HOPPER).split("inline bool tile_map_f32(", 1)[1]
        code = code.split("\n}\n", 1)[0]
        for needle in ("CU_TENSOR_MAP_DATA_TYPE_FLOAT32",
                       "CU_TENSOR_MAP_SWIZZLE_128B", "(cuuint32_t)kAtomF32",
                       "(cuuint64_t)sh * 4", "(cuuint64_t)ss * 4",
                       "(cuuint64_t)sb * 4",
                       "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE"):
            assert needle in code, needle


# -------------------------------------------------------------- operands
def _reference_views(B=2, H=8, KVH=2, S=100, D=64):
    """q, k, v, o, dout in the reference signature's (B, H, S, D) layout,
    viewed in the model layout, f32."""
    q, o, dout = (torch.zeros((B, H, S, D), dtype=F32).transpose(1, 2)
                  for _ in range(3))
    k, v = (torch.zeros((B, KVH, S, D), dtype=F32).transpose(1, 2)
            for _ in range(2))
    return q, k, v, o, dout


class TestOperands:
    @pytest.mark.parametrize("layout", ["contiguous", "fused", "reference"])
    def test_strided_views_are_read_as_they_lie(self, layout):
        B, S, H, KVH, D = 2, 100, 8, 2, 64
        if layout == "contiguous":
            q, o, dout = (torch.zeros((B, S, H, D), dtype=F32)
                          for _ in range(3))
            k, v = (torch.zeros((B, S, KVH, D), dtype=F32) for _ in range(2))
        elif layout == "fused":
            qkv = torch.zeros((B, S, H + 2 * KVH, D), dtype=F32)
            q, k, v = qkv.split([H, KVH, KVH], dim=2)
            o = torch.zeros_like(q)
            dout = torch.zeros((B, S, H + 2 * KVH, D), dtype=F32)[:, :, :H]
        else:
            q, k, v, o, dout = _reference_views(B, H, KVH, S, D)
        lse = torch.zeros((B, H, S), dtype=F32)
        got = fa.bwd_operands(q, k, v, o, lse, dout)
        for a, b in zip(got[:6], (q, k, v, o, lse, dout)):
            assert a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
        assert got[6] == (*q.stride()[:3], *k.stride()[:3], *o.stride()[:3],
                          *dout.stride()[:3])

    def test_what_rows_aligned_refuses_is_copied(self):
        q = torch.zeros((2, 9, 4, 66), dtype=F32)[..., :64]
        k = torch.zeros((2, 9, 2, 64), dtype=F32)
        lse = torch.zeros((2, 4, 9), dtype=F32)
        got = fa.bwd_operands(q, k, k, q, lse, q)
        for t in (got[0], got[3], got[5]):
            assert t.is_contiguous() and t.data_ptr() != q.data_ptr()
        assert got[1].data_ptr() == k.data_ptr()

    def test_k_and_v_with_other_strides_are_both_copied(self):
        k = torch.zeros((2, 9, 2, 64), dtype=F32)
        v = torch.zeros((2, 2, 9, 64), dtype=F32).transpose(1, 2)
        q = torch.zeros((2, 9, 4, 64), dtype=F32)
        lse = torch.zeros((2, 4, 9), dtype=F32)
        _, k2, v2, *_ = fa.bwd_operands(q, k, v, q, lse, q)
        assert k2.stride() == v2.stride() == k.stride()
        assert v2.data_ptr() != v.data_ptr()

    def test_an_unaligned_lse_is_cloned(self):
        lse = torch.zeros(2 * 4 * 9 + 1, dtype=F32)[1:].view(2, 4, 9)
        assert lse.data_ptr() % 16 == 4
        q = torch.zeros((2, 9, 4, 64), dtype=F32)
        k = torch.zeros((2, 9, 2, 64), dtype=F32)
        got = fa.bwd_operands(q, k, k, q, lse, q)[4]
        assert got.data_ptr() % 16 == 0 and torch.equal(got, lse)

    def test_the_c_entry_takes_the_strides(self):
        """The f32 backward entry: ten tensors, the group scratch, six
        ints, the twelve strides, causal, window, q_off, the stream; the
        bf16 one without the scratch."""
        f32 = SIGNATURES["repro_flash_attention_bwd"]
        tc = SIGNATURES["repro_flash_attention_tc_bwd"]
        assert f32 == tc[:10] + [tc[0]] + tc[10:]
        assert len(f32) == 11 + 6 + 12 + 4
        head = _code(SRC).split('extern "C" int repro_flash_attention_bwd(',
                                1)[1].split(")", 1)[0]
        assert head.count("long long") == 12


# ------------------------------------------------------------------ route
class TestRoute:
    @pytest.mark.parametrize("D", fa.SUPPORTED_HEAD_DIMS)
    def test_float32_takes_the_f32_route(self, D):
        assert fa.route(F32, D) == fa.F32
        assert fa.forward_entry(F32, D, fa.DECODE_MAX_ROWS + 1) == fa.F32.fwd
        assert fa.forward_entry(F32, D, fa.DECODE_MAX_ROWS) == fa.DECODE

    def test_the_entries_keep_their_names_and_home(self):
        assert fa.F32 == fa.Route("repro_flash_attention_fwd",
                                  "repro_flash_attention_bwd")
        for name in fa.F32:
            homes = [p.name for p in sorted(CSRC.glob("*.cu"))
                     if f'extern "C" int {name}(' in p.read_text()]
            assert homes == [SRC.name]


# ----------------------------------------------------------------- sources
class TestSources:
    def test_every_product_is_tf32_wgmma_fed_by_tma(self):
        code = _code(SRC) + _code(HOPPER)
        for needle in ("wgmma.mma_async.sync.aligned.m64n", "k8.f32.tf32.tf32",
                       "wgmma.fence", "wgmma.commit_group",
                       "wgmma.wait_group", "cp.async.bulk.tensor.4d",
                       "cp.async.bulk.tensor.1d", "mbarrier.try_wait",
                       "mbarrier.arrive.expect_tx", "fence.proxy.async",
                       "tile_map_f32(", "split_tf32("):
            assert needle in code, needle
        for kernel in ("flash_f32_fwd(", "flash_f32_bwd_dq(",
                       "flash_f32_bwd_dkdv("):
            assert ("__global__ void __launch_bounds__(kThreads, 1) "
                    + kernel) in code

    def test_no_ffma_kernel_is_left(self):
        code = _code(SRC)
        for gone in ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                     "flash_bwd_dq_kernel", "flash_bwd_delta_kernel",
                     "stage_rows", "bwd_scores", "mma.sync", "Tile<D>::kLD"):
            assert gone not in code, gone
        # the one FFMA product left: rowsum(dO * O) of a q tile's rows
        assert code.count("fmaf(x.") == 4

    @pytest.mark.parametrize("N", [32, 64, 128, 192])
    def test_each_product_width_has_a_wrapper(self, N):
        code = _code(HOPPER)
        assert f"void wgmma_tf32<{N}>(" in code
        assert f"m64n{N}k8.f32.tf32.tf32" in code

    @pytest.mark.parametrize("R,D", [(64, 64), (32, 128), (64, 128),
                                     (32, 192)])
    def test_the_transposed_tiles_take_the_fragment_order(self, R, D):
        """transpose_tile's offsets, run here for every thread: source row
        r, column n lands in row n of the result at column
        8 (r / 8) + (r % 8) / 2 + 4 (r % 2), the column at which
        frag_from_acc's fragment takes the accumulator's column r (its
        columns t, t + 4 are the accumulator's 2t, 2t + 1), both tiles
        128-byte swizzled K-major atoms; each element written once."""
        code = _code(SRC)
        body = " ".join(code.split("void transpose_tile(", 1)[1]
                        .split("\n}\n", 1)[0].split())
        for needle in ("const int par = tid >> 6;",
                       "const int n = blk * 64 + (tid & 63);",
                       "+ ((n & 3) << 2) + par * kAtomRow;",
                       "sw[i] = 2 * i * kAtomRow + (((((n & 31) >> 2) ^ "
                       "(par + 2 * i))) << 4);",
                       "col + 8 * k * kAtomRow + sw[i]",
                       "const int off = (k >> 2) * D * kAtomRow + n * kAtomRow"
                       " + (((2 * (k & 3) + par) ^ (n & 7)) << 4);"):
            assert needle in body, needle
        acc = code.split("void frag_from_acc(", 1)[1].split("\n}\n", 1)[0]
        order = re.findall(r"c\[4 \* kk(?: \+ (\d))?\], big\[(\d)\]", acc)
        assert [(int(a or 0), int(b)) for a, b in order] == \
            [(0, 0), (2, 1), (1, 2), (3, 3)]

        def swz(rows, r, c):            # (r, c) of a 128-byte swizzled tile
            return ((c >> 5) * rows * 128 + r * 128
                    + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2))

        got = {}
        for tid in range(128):
            par = tid >> 6
            for blk in range(D // 64):
                n = blk * 64 + (tid & 63)
                col = (n >> 5) * R * 128 + ((n & 3) << 2) + par * 128
                sw = [2 * i * 128 + ((((n & 31) >> 2) ^ (par + 2 * i)) << 4)
                      for i in range(4)]
                for k in range(R // 8):
                    off = ((k >> 2) * D * 128 + n * 128
                           + (((2 * (k & 3) + par) ^ (n & 7)) << 4))
                    for i in range(4):
                        src = col + 8 * k * 128 + sw[i]
                        assert off + 4 * i not in got
                        got[off + 4 * i] = src
        assert len(got) == R * D
        for r in range(R):
            p = 8 * (r // 8) + (r % 8) // 2 + 4 * (r % 2)
            for n in range(D):
                assert got[swz(D, n, p)] == swz(R, r, n)
