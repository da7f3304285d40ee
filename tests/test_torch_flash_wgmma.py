"""What surrounds the bf16 flash forward of ``csrc/flash_attention_wgmma.cu``
(wgmma on tiles that TMA copies into shared memory), on the CPU: the kernel
itself runs only on the card, where ``chip_smoke.py`` holds it against the
plain version.

* each supported head dim runs the instance ``fwd_instance`` names, the C
  dispatch and key tiles agree, and the columns past the head dim are
  zero-filled by the copy and never written;
* the tensor maps' dims, byte strides and boxes (``tensor_map``) for
  contiguous tensors, the model path's strided q / k / v views of a fused
  projection and the reference signature's transposed views;
* which tensors ``_rows_aligned``'s rule copies before a launch;
* a bf16 forward at Sq > ``DECODE_MAX_ROWS`` takes this kernel's entry,
  at or below it the decode kernel; ``route`` still raises for other
  dtypes and head dims;
* the sources: the forward issues ``wgmma`` on operands that
  ``cp.async.bulk.tensor`` brought in (its helpers in ``hopper.cuh``), and
  no ``mma.sync`` forward is left; the tile predicates have one home
  (``flash_mask.cuh``).
"""

from __future__ import annotations

import re

import pytest
import torch

from repro_torch.kernels._build import CSRC, SIGNATURES
from repro_torch.kernels.flash_attention import flash_attention as fa

WGMMA = CSRC / "flash_attention_wgmma.cu"
BWD = CSRC / "flash_attention_wgmma_bwd.cu"
HOPPER = CSRC / "hopper.cuh"
BF16 = torch.bfloat16


def _code(path) -> str:
    """A source without its // comments."""
    return re.sub(r"//[^\n]*", "", path.read_text())


def _code_with_header(path) -> str:
    """A source and the Hopper helpers it includes, without comments."""
    assert '#include "hopper.cuh"' in path.read_text()
    return _code(path) + _code(HOPPER)


# ---------------------------------------------------------------- instances
INSTANCE = {16: 64, 32: 64, 48: 64, 64: 64, 80: 128, 96: 128, 112: 128,
            128: 128, 192: 192}


class TestInstances:
    @pytest.mark.parametrize("D", fa.SUPPORTED_HEAD_DIMS)
    def test_each_head_dim_runs_its_instance(self, D):
        assert fa.fwd_instance(D) == INSTANCE[D]
        assert fa.fwd_instance(D) >= D
        assert fa.fwd_instance(D) % fa.WGMMA_ATOM == 0

    def test_the_c_dispatch_agrees(self):
        """``repro_flash_attention_tc_fwd``'s switch sends each head dim
        to the instance ``fwd_instance`` names, and no other."""
        body = _code(WGMMA).split("repro_flash_attention_tc_fwd(", 1)[1]
        cases = []
        got = {}
        for tok in re.finditer(r"case (\d+):|fwd_launch<(\d+)>", body):
            if tok.group(1):
                cases.append(int(tok.group(1)))
            else:
                got.update(dict.fromkeys(cases, int(tok.group(2))))
                cases = []
        assert got == INSTANCE
        assert sorted(got) == sorted(fa.SUPPORTED_HEAD_DIMS)

    @pytest.mark.parametrize("D", fa.SUPPORTED_HEAD_DIMS)
    def test_key_tile(self, D):
        want = {64: 128, 128: 112, 192: 64}[INSTANCE[D]]
        assert fa.fwd_key_tile(D) == want
        assert "kBK = D == 64 ? 128 : D == 128 ? 112 : 64" in _code(WGMMA)
        assert want % 16 == 0 and want <= 256   # k16 steps; a box's rows

    def test_padding_columns_cost_what_the_source_says(self):
        """The products past the head dim: 60 % more at D = 80, 14 % at
        D = 112 (the source's header and PERF.md)."""
        assert round(fa.fwd_instance(80) / 80 - 1, 2) == 0.60
        assert round(fa.fwd_instance(112) / 112 - 1, 2) == 0.14
        assert fa.fwd_instance(128) == 128 and fa.fwd_instance(192) == 192

    @pytest.mark.parametrize("D", fa.SUPPORTED_HEAD_DIMS)
    def test_columns_past_the_head_dim_are_zero_filled(self, D):
        """The maps carry the true head dim and a box one atom wide, so a
        box at column 64 a past D reads zeros; the instance's atoms cover
        the head dim."""
        q = torch.zeros((1, 200, 4, D), dtype=BF16)
        m = fa.tensor_map(q, fa.WGMMA_ROWS)
        assert m.dims[0] == D
        assert m.box[0] == fa.WGMMA_ATOM
        atoms = fa.fwd_instance(D) // fa.WGMMA_ATOM
        assert (atoms - 1) * fa.WGMMA_ATOM < D <= atoms * fa.WGMMA_ATOM

    def test_columns_past_the_head_dim_are_never_written(self):
        """The epilogue stores n8 column groups below head_dim only, into
        an o whose rows are head_dim wide."""
        code = _code(WGMMA)
        assert "if (8 * i < head_dim)" in code
        assert "* head_dim + 2 * tq" in code


# ------------------------------------------------------------- tensor maps
def _views(B=2, S=300, H=8, KVH=2, D=128):
    """q, k, v as the model path gives them: views of one fused
    (B, S, H + 2 KVH, D) projection."""
    qkv = torch.zeros((B, S, H + 2 * KVH, D), dtype=BF16)
    return qkv.split([H, KVH, KVH], dim=2)


class TestTensorMap:
    def test_contiguous(self):
        q = torch.zeros((2, 300, 8, 128), dtype=BF16)
        m = fa.tensor_map(q, fa.WGMMA_ROWS)
        assert m == fa.TensorMap((128, 8, 300, 2),
                                 (256, 8 * 256, 300 * 8 * 256),
                                 (64, 1, 128, 1))

    def test_key_box_is_the_key_tile(self):
        k = torch.zeros((2, 300, 2, 192), dtype=BF16)
        m = fa.tensor_map(k, fa.fwd_key_tile(192))
        assert m.box == (64, 1, 64, 1)
        assert m.dims == (192, 2, 300, 2)
        assert fa.tensor_map(k[..., :128], fa.fwd_key_tile(128)).box == \
            (64, 1, 112, 1)

    def test_model_path_views_of_a_fused_projection(self):
        q, k, v = _views()
        row = (8 + 2 * 2) * 128 * 2          # bytes between two positions
        for t, heads in ((q, 8), (k, 2), (v, 2)):
            m = fa.tensor_map(t, 128)
            assert m.dims == (128, heads, 300, 2)
            assert m.strides == (256, row, 300 * row)
            assert fa._rows_aligned(t)
        assert k.stride() == v.stride()

    def test_reference_signature_views(self):
        """``flash_attention_kernel`` passes (B, H, S, D) tensors as
        (B, S, H, D) views: the head stride is S rows, the sequence
        stride one row."""
        B, H, KVH, S, D = 2, 8, 2, 100, 64
        q = torch.zeros((B, H, S, D), dtype=BF16).transpose(1, 2)
        k = torch.zeros((B, KVH, S, D), dtype=BF16).transpose(1, 2)
        mq, mk = fa.tensor_map(q, 128), fa.tensor_map(k, 128)
        assert mq.dims == (D, H, S, B)
        assert mq.strides == (S * D * 2, D * 2, H * S * D * 2)
        assert mk.strides == (S * D * 2, D * 2, KVH * S * D * 2)
        assert fa._rows_aligned(q) and fa._rows_aligned(k)

    def test_a_dim_of_one_gets_a_valid_stride(self):
        """One batch or one head never steps its stride: the map takes
        S times the row stride, or the head dim."""
        k = torch.zeros((1, 40, 1, 64), dtype=BF16)
        m = fa.tensor_map(k, 128)
        assert m.strides == (64 * 2, 64 * 2, 40 * 64 * 2)

    @pytest.mark.parametrize("view", ["contiguous", "fused", "reference",
                                      "batch_slice", "narrow_d"])
    def test_every_stride_of_a_tensor_read_as_it_lies_suits_tma(self, view):
        base = torch.zeros((3, 130, 12, 136), dtype=BF16)
        t = {"contiguous": base[..., :128].contiguous(),
             "fused": base[:, :, 4:8, :128],
             "reference": base[..., :128].permute(0, 2, 1, 3),
             "batch_slice": base[1:, :, :, :128],
             "narrow_d": base[..., :120]}[view]
        assert fa._rows_aligned(t)
        m = fa.tensor_map(t, 128)
        assert all(s % 16 == 0 and 0 < s < 2 ** 40 for s in m.strides)


# ----------------------------------------------------------- rows aligned
class TestRowsAligned:
    """Which tensors ``flash_attention_fwd`` copies to a contiguous tensor
    before a launch."""

    def test_contiguous_and_fused_views_are_read_as_they_lie(self):
        assert fa._rows_aligned(torch.zeros((2, 9, 4, 64), dtype=BF16))
        assert all(fa._rows_aligned(t) for t in _views())

    def test_a_stride_that_is_no_multiple_of_16_bytes_is_copied(self):
        wide = torch.zeros((2, 9, 4, 68), dtype=BF16)    # rows of 136 B
        assert not fa._rows_aligned(wide[..., :64])

    def test_a_misaligned_base_is_copied(self):
        flat = torch.zeros(2 * 9 * 4 * 64 + 4, dtype=BF16)
        t = flat[4:].view(2, 9, 4, 64)                  # 8 bytes in
        assert t.data_ptr() % 16 == 8
        assert not fa._rows_aligned(t)

    def test_a_strided_head_dim_is_copied(self):
        t = torch.zeros((2, 9, 64, 4), dtype=BF16).transpose(2, 3)
        assert t.stride(-1) != 1
        assert not fa._rows_aligned(t)

    def test_f32_rows_keep_their_rule(self):
        """f32: 16-byte multiples are 4 elements (the f32 route's tensor
        maps)."""
        t = torch.zeros((2, 9, 4, 68), dtype=torch.float32)
        assert fa._rows_aligned(t[..., :64])
        u = torch.zeros((2, 9, 4, 66), dtype=torch.float32)
        assert not fa._rows_aligned(u[..., :64])


# -------------------------------------------------------- entries, routes
class TestEntry:
    @pytest.mark.parametrize("D", fa.SUPPORTED_HEAD_DIMS)
    @pytest.mark.parametrize("Sq", [1, 8, 9, 128, 4096])
    def test_bf16_forward_entry(self, D, Sq):
        want = fa.DECODE if Sq <= fa.DECODE_MAX_ROWS else \
            "repro_flash_attention_tc_fwd"
        assert fa.forward_entry(BF16, D, Sq) == want
        assert fa.TENSOR_CORES.fwd == "repro_flash_attention_tc_fwd"

    def test_the_bf16_entries_live_where_the_header_says(self):
        defined = {name: [p.name for p in sorted(CSRC.glob("*.cu"))
                          if f'extern "C" int {name}(' in p.read_text()]
                   for name in SIGNATURES}
        assert defined["repro_flash_attention_tc_fwd"] == [WGMMA.name]
        assert defined["repro_flash_attention_tc_bwd"] == [BWD.name]

    @pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                       torch.int8])
    def test_route_raises_for_other_dtypes(self, dtype):
        with pytest.raises(ValueError, match="dtype"):
            fa.route(dtype, 128)
        with pytest.raises(ValueError):
            fa.forward_entry(dtype, 128, 4096)

    @pytest.mark.parametrize("D", [8, 24, 100, 160, 256])
    def test_route_raises_for_other_head_dims(self, D):
        for dtype in (BF16, torch.float32):
            with pytest.raises(ValueError, match="head_dim"):
                fa.route(dtype, D)
        with pytest.raises(ValueError, match="head_dim"):
            fa.fwd_instance(D)


# ------------------------------------------------------------------ sources
class TestSources:
    def test_the_forward_is_wgmma_fed_by_tma(self):
        code = _code_with_header(WGMMA)
        for needle in ("wgmma.mma_async.sync.aligned.m64n", "wgmma.fence",
                       "wgmma.commit_group", "wgmma.wait_group",
                       "cp.async.bulk.tensor.4d", "mbarrier.try_wait",
                       "mbarrier.arrive.expect_tx", "setmaxnreg.dec",
                       "setmaxnreg.inc", "CU_TENSOR_MAP_SWIZZLE_128B",
                       "__global__ void __launch_bounds__(kThreads, 1) "
                       "flash_wgmma_fwd("):
            assert needle in code, needle
        # the register A operand of P V, B MN-major (transpose bit set)
        assert re.search(r"\{%\d+, %\d+, %\d+, %\d+\}, %\d+, p, 1, 1, 1;",
                         code)

    def test_no_mma_sync_forward_is_left(self):
        for path in (WGMMA, BWD, HOPPER):
            assert "mma.sync" not in _code(path)
            assert "ldmatrix" not in _code(path)
        bwd = _code(BWD)
        assert "flash_tc_fwd" not in bwd
        assert "repro_flash_attention_tc_fwd(" not in bwd
        assert not (CSRC / "flash_attention_tc.cu").exists()

    @pytest.mark.parametrize("helper", ["tile_full", "k_range", "floor_div",
                                        "tile_needed", "row_pair_valid",
                                        "pair_valid"])
    def test_tile_predicates_have_one_home(self, helper):
        pat = re.compile(rf"__device__ __forceinline__ \w+ {helper}\(")
        homes = [p.name for p in sorted(CSRC.glob("*.cu*"))
                 if pat.search(p.read_text())]
        assert homes == ["flash_mask.cuh"]

    @pytest.mark.parametrize("src", ["flash_attention.cu",
                                     "flash_attention_wgmma_bwd.cu",
                                     "flash_attention_wgmma.cu",
                                     "flash_decode.cu"])
    def test_every_flash_source_includes_the_mask_header(self, src):
        assert '#include "flash_mask.cuh"' in (CSRC / src).read_text()

    def test_no_block_predicate_is_written_out_again(self):
        """The f32 kernels ask ``flash_mask.cuh`` for their tile ranges with
        their own tile sizes: ``k_range`` in the forward and dQ, the q
        tiles of a k tile through ``floor_div`` in dK/dV."""
        code = _code(CSRC / "flash_attention.cu")
        assert "block_needed" not in code
        assert code.count("k_range(q_off + q0, kRows, kBK, Sk, causal, "
                          "window, j_lo, j_hi)") == 2
        assert code.count("floor_div(") == 2
