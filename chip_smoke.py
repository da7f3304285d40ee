#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA device (built and measured for an NVIDIA H100, sm_90a) and
``nvcc``; exits non-zero without them.  Imports ``repro_torch`` only.

Phases, one JSON line each:

1. ``device``        card name and power limit (``nvidia-smi``), versions;
2. ``build``         nvcc build of the kernels' library, ptxas resources
                     of each kernel (registers and spills of every
                     paged-attention instance apart), tensor-core
                     instructions counted in its SASS (``cuobjdump``; every
                     bf16 flash kernel, forward and backward, must be
                     wgmma alone: HGMMA > 0, HMMA 0; neither they, the
                     head_dim 192 flash kernels nor the 31 decode-kernel
                     instances spill);
3. ``kernels``       every CUDA kernel against its plain PyTorch version on
                     the card (small shapes incl. window masking, unmapped
                     pages, rows with no valid position, splits that see
                     only masked rows, paged attention at every cluster
                     size the plan can pick and at the native context of
                     32,768 tokens, two calls bit-identical, scatter
                     leaving other rows alone, gather∘scatter round trip;
                     flash
                     attention forward and backward, causal / window /
                     non-causal, G 1 and 5, ragged S, D 16-192, q/k/v as
                     views of one fused tensor, f32 (CUDA cores) and bf16
                     (tensor cores); and each path's shapes), with times;
                     paged attention at head_dim 80 (H2O-Danube's heads, a
                     window that masks) and 112 (Zamba2-7B's), each beside
                     SDPA on pre-gathered K/V, and at page sizes 1, 3 and
                     17 (row copies) with the cost of small pages; flash at
                     DeepSeek-V3's H=128, D=192 and Zamba2-7B's H=32,
                     D=112 (bf16 at S=4096, f32 shorter); flash at
                     Sq != Sk (cross-attention, non-causal: Sq 1-448 over
                     Sk 1-1,500, Sq > Sk, G 1 and 4, D 64 and 128, views;
                     a causal or windowed call at Sq != Sk must raise
                     ValueError) and at Whisper-medium's decode (Sq = 1
                     over 1,500 frames, B 4 and 1: the few-row decode
                     kernel, beside the tile kernel and SDPA), cross (448
                     over 1,500) and encoder (S = 1,500) shapes beside
                     SDPA; the decode kernel at masked few-row shapes with
                     a query offset, every cluster size, lse, two calls
                     bit-identical, and its forward followed by the
                     backward kernels; the bf16 wgmma forward and
                     backward at every head dim, Sq 9, Mixtral's window at
                     S 4,500, Whisper's cross shape, query offsets on and
                     off the tiles and KVH 1, forward and gradients, two
                     calls of each bit-identical at each instance, the
                     backward given the reference signature's views equal
                     to it given contiguous tensors; the f32 route at the
                     training shape
                     and the training example's call beside SDPA, the
                     backward's two calls bit-identical;
                     ``flash_attention_kernel`` in the reference's
                     signature and (B, H, S, D) layout; the copies at
                     the Qwen3, the latent and the Zamba2 KV rows against
                     index_select / index_copy_ and an empty kernel (the
                     launch floor), Zamba2's with -1 and past-the-pool
                     indices;
3a. ``seq_split``    the flash kernels at a query offset: a sequence split
                     over 16 ranks emulated in one process, as
                     ``models.attention._flash_dist`` runs each rank (its
                     rows of q at ``q_offset`` over the whole K/V,
                     forward and backward through autograd; counters
                     zeroed just before the ranks' calls and read just
                     after, path ``seq_split``) at Qwen3-14B's training
                     shape, Mixtral-8x7B's heads at S = 8,192 with its
                     4,096-token window, StarCoder2-3B's heads in f32 at
                     S = 1,536 (96 rows a rank: no tile multiple) and
                     H2O-Danube's D = 80; each rank against the plain
                     version at its offset, the ranks' outputs and dq
                     concatenated and dk, dv summed against the whole
                     call (bits equal or not), each rank's and the whole
                     call's device ms beside their bounds (K/V read over
                     the keys a rank's mask reaches), the plain version's
                     and SDPA's (over the offset mask) at the first,
                     middle and last rank and the whole call;
3b. ``dist_local``   the shard-local paged decode at Qwen3-14B's decode
                     shape (bf16, the kernels phase's lengths): two data
                     ranks in one process, each on its slice of the pool
                     (a view) and its rows of the page table rebased to
                     it; one paged-attention launch a rank (counters
                     zeroed just before, read just after); each rank's
                     output and pools against the plain version and the
                     unsharded kernel call;
3c. ``dist_step``    the dense family's decode step and train step with
                     DTensor parameters on a (1 x 1) DeviceMesh over a
                     one-rank NCCL group, under the arch's logical rules,
                     against the same steps with plain parameters:
                     Qwen3-14B at published width cut to 2 layers, one
                     decode step at batch 4 over 256-token pages and one
                     train step at 2 x 4,096 in 2 microbatches with remat;
                     launches by kernel of each run (counters zeroed just
                     before, read just after) equal and non-zero, logits,
                     pools, loss and updated parameters within the bf16
                     tolerance, bits equal or not, the phase's seconds;
3d. ``dist_families`` the same for the five other families at published
                     width (``Sizes.dist_family_*``): Mixtral-8x7B,
                     DeepSeek-V3, Zamba2-7B and xLSTM-125M here,
                     Whisper-medium in the side process
                     (``dist_families_side``); launches equal, and
                     non-zero for every kernel the plain step launches
                     (Mixtral: paged, flash; DeepSeek-V3 train: flash at
                     head_dim 192, its MLA decode none of ours; Zamba2:
                     paged, flash; Whisper: paged, flash at Sq = 1 and 448
                     over 1,500; xLSTM: none), logits, every cache leaf,
                     loss and updated parameters within the bf16
                     tolerance, bits equal or not;
3e. ``examples``    (in the side process, below) the example
                     twins in subprocesses on the card, counters zeroed in
                     each just before the script and read just after:
                     ``torch_serve_paged_kv.py`` at its defaults (the
                     reference's ring-buffer scenario: no kernel of ours)
                     and with ``--window 0`` (paged attention, the page
                     copies), both printing the reference's two stats
                     lines; ``torch_train_demand_paged.py`` at its default
                     f32 size, 52.4M parameters (flash on its f32 route,
                     ``PagedAdamW``'s page copies) for 2 steps with a
                     checkpoint, then a restart that resumes from it for
                     1 more; finite losses;
4. ``decode_parity`` one full-width ``decode_step`` (2 layers), kernel path
                     against plain path;
5. ``spill_parity``  the serve scenario at 2 layers: an undersized KV pool
                     (spills, fault-back-ins) generates the same tokens as
                     an exact-fit pool;
6. ``serve``         ``ServingEngine`` on full-width, full-depth Qwen3-14B
                     with random weights, greedy, undersized KV pool; launch
                     counters are zeroed just before and read just after;
6b. ``serve_danube`` ``ServingEngine`` on H2O-Danube-1.8B at published width
                     and depth (24 layers, head_dim 80), the serve settings
                     and undersized pool, its window off (it masks nothing
                     inside the 1,024-token context; with it the decoder
                     keeps a ring buffer, not the paged pools); counters
                     zeroed just before the kernel path and read just
                     after (paged attention = 24 x decode_step calls); the
                     plain path on the card gives the same greedy tokens;
                     then the published config on its ring path at its
                     first 12 layers (the whole run's time);
6c. ``serve_hybrid`` ``ServingEngine`` on Zamba2-7B at published width (81
                     Mamba2 layers, 13 groups of 6 and a tail of 3, one
                     shared attention block at 13 sites, head_dim 112),
                     the engine run cut to 15 layers (2 groups and the
                     tail; the whole run's time), the serve settings and
                     undersized pool; counters zeroed just before the
                     kernel path and read just after (paged attention =
                     2 x decode_step calls); the bytes a step moves per
                     sequence, paged KV against pinned Mamba state against
                     the weights, and a batch-1 decode step profiled, both
                     at full depth; ``serve_hybrid_plain``: at the model's
                     first 15 layers, every bf16 kernel call of the path
                     against its plain version, and in f32 the plain path
                     on the card gives the same greedy tokens (bf16
                     logits tie);
6d. ``serve_encdec`` ``ServingEngine`` on Whisper-medium at published width
                     and depth (24 encoder and 24 decoder layers, d 1,024,
                     16 heads of 64), max_len 448, 5 frames against 8, six
                     greedy requests of 4-224 tokens, 16 new each; the
                     engine decodes over the zero cross K/V, as the
                     reference's; counters zeroed just before and read just
                     after (paged attention and flash = 24 x decode_step
                     calls, every flash call on the decode kernel);
                     paged self-KV against pinned cross K/V bytes a step;
                     a batch-1 step profiled (``flash_decode_kernel``
                     among its kernels); then a decode over
                     ``cross_kv(encode(frames))`` of random frames: f32
                     greedy tokens kernel = plain path on the card, every
                     bf16 flash call (encoder, cross) against its plain
                     version;
7. ``serve_mla_moe`` ``ServingEngine`` on DeepSeek-V3 at published width cut
                     to 4 layers (3 dense, 1 MoE of 256 experts), paged
                     latent pools: the same greedy requests on an exact-fit
                     and an undersized pool give identical tokens; the
                     engine's latent-pool copies against ``ref.py`` bit for
                     bit; a batch-1 decode step profiled; counters zeroed
                     just before the undersized run and read just after;
7a. ``serve_xlstm``  ``ServingEngine`` on xLSTM-125M at published width and
                     depth (12 blocks, d 768, sLSTM at 5 and 11; no
                     attention, no KV pages, no kernel of this repo: its
                     23,679,136 B of decode state a sequence pinned and
                     copied into and out of a batch slot every step), the
                     serve settings over an exact-fit pool; counters
                     zeroed just before and read just after, each 0; bf16
                     logits finite; the pinned bytes a step and their
                     copies' device ms; a batch-1 step profiled; in f32
                     at 6 layers (the first mLSTM run and the sLSTM block
                     at 5), the engine's greedy tokens at max_batch
                     1 and 4 against a direct decode loop per request (a
                     token may differ only on a top-2 margin below 1e-4 x
                     max|logit|);
7b. ``remote_paging`` the reference's remote-paging scenario
                     (``benchmarks/vmem_remote.py::_store_remote``):
                     ``PagedTensorStore`` over ``RemoteFramePool`` over a
                     ``DeviceFramePool`` on the card, rows of a Qwen3-14B
                     KV page (524,288 B; bf16 where ``ml_dtypes`` is
                     installed, else as f32), a backing region of two
                     preempted 1,024-token sequences (640 pages) on a
                     remote node and a pool of one (320 frames); for
                     Touch-A-Page, Touch-Ahead and STREAM, A, B, A again,
                     every gathered row bit for bit against the seed's,
                     the cold pass must take destination faults and RAPF
                     retransmits; then a crash of the primary backing node
                     halfway through A's return trip fails over to the
                     replica (read-your-writes, rows exact); counters
                     zeroed just before and read just after;
8. ``train_parity``  full width, 2 layers, f32, one batch of 2×512: loss and
                     every gradient, kernel path on the card against the
                     plain path on the CPU; one AdamW update on each; and
                     ``PagedAdamW`` against AdamW on the card;
9. ``train``         ``Trainer`` on full-width Qwen3-14B cut to 2 layers,
                     seq 4096, batch 2 in 2 microbatches, remat, bf16
                     params, f32 moments, 4 steps; a checkpoint at step 2
                     restored into a fresh trainer repeats step 3's loss;
                     launch counters zeroed just before the 4 steps and read
                     just after;
9b. ``train_mla``   ``Trainer`` on DeepSeek-V3 at published width cut to its
                     3 dense layers (first_k_dense), seq 4096, batch 2 in 2
                     microbatches, remat, 3 steps: flash at head_dim 192;
                     first a one-layer f32 kernel-path against plain-path
                     parity of the loss and every gradient; counters zeroed
                     just before the steps and read just after;
9c. ``train_hybrid`` ``Trainer`` on Zamba2-7B at published width cut to
                     15 layers (2 groups of 6 and a tail of 3), the train
                     shape, 3 steps: flash at head_dim 112, finite losses
                     and gradient norms (Mamba2's chunk of 128); first a
                     one-group f32 kernel-path against plain-path parity
                     of the loss and every gradient; counters zeroed just
                     before the steps and read just after;
9d. ``train_encdec`` ``Trainer`` on Whisper-medium at published width and
                     depth, tokens (8, 448) in 2 microbatches, remat, bf16
                     params, f32 moments, 3 steps on zero frames: flash on
                     the encoder, the decoder and the cross-attention
                     (Sq 448 over Sk 1,500), finite losses and gradient
                     norms; first a 2 + 2-layer f32 kernel-path against
                     plain-path parity of the loss and every gradient over
                     random frames; counters zeroed just before the steps
                     and read just after;
9e. ``train_xlstm``  ``make_train_step`` on xLSTM-125M at published width cut
                     to 2 layers (an mLSTM layer and the sLSTM block: the
                     step is a Python loop over tokens, at 12 layers 56-59
                     s), tokens (4, 1024) in one microbatch, remat (each
                     mLSTM layer, and each 64-token chunk of the
                     recurrences), bf16 params, f32 moments, 3 steps:
                     finite losses and gradient norms, counters each 0;
                     first a 3-layer f32 parity of the loss and every
                     gradient, the card against the CPU; then one step at
                     4 x 64 tokens profiled;
10. ``train_moe``    ``Trainer`` on Mixtral-8x7B at published width cut to 2
                     layers, the same shape and steps, loss and aux loss
                     each step; a one-layer kernel-path against
                     plain-path parity first, f32 and bf16 (top-2 flips
                     counted); the
                     state after step 2 copied to the host and back repeats
                     step 3's loss; one MoE layer's forward in its parts;
11. ``profile``      only with ``--profile``: one batch-1 decode step under
                     ``torch.profiler``, host time against device time
                     (and, inside ``train``, ``train_encdec`` and
                     ``train_moe``, one training step).

``examples``, ``serve_xlstm``, ``train_xlstm``, ``remote_paging``,
``serve_hybrid_plain`` and ``dist_families_side`` run in a second process
on the same card
(``--side``), started after ``seq_split`` and waited for after
``serve_danube``; the phases in between time no kernel, and the side
phases' lines come after ``serve_danube``'s.

Then each phase's wall seconds (``phase_seconds``), one
``{"kernels": [...]}`` line (per kernel: launches summed over the paths
that launch it, and by path; error, time, plain / library time, roofline
bound), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
Any failing phase raises: the run exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20          # H100 SXM data sheet
# dense, by input type; "float32" the CUDA cores', "tf32" the tensor
# cores' (the f32 flash route takes three TF32 products a product)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}

TOL = {"float32": 2e-5, "bfloat16": 2e-2}     # atol = rtol, as the CPU tests
GRAD_TOL_F32 = 1e-4                           # flash gradients, f32


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------- sizes
@dataclasses.dataclass
class Sizes:
    """Shapes of the run; the defaults are the serving path's on Qwen3-14B."""
    arch: str = "qwen3_14b"
    full_width: bool = True
    serve_layers: int = 0            # 0 = the config's own depth
    parity_layers: int = 2
    max_batch: int = 4
    pages_per_seq: int = 4
    pool_frames: int = 5
    prompts: tuple = (320, 80, 576, 288, 144, 432)
    max_new: int = 8
    timing_iters: int = 50
    timing_layers: int = 8           # distinct pools cycled through: L2-cold
    long_pages: int = 128            # 128 x 256 = 32,768: Qwen3-14B's native
    flash_iters: int = 10            # timed calls at the training shape
    # seq_split: a sequence split over seq_split_ranks ranks (the
    # production mesh's 'model' = 16), each rank's calls timed
    # seq_split_iters times; the f32 case at seq_split_f32_seq (96 rows a
    # rank: no multiple of the f32 kernels' 64-row tiles)
    seq_split_ranks: int = 16
    seq_split_iters: int = 5
    seq_split_f32_seq: int = 1536
    # examples: the training twin's steps before its checkpoint, and after
    # the restart that resumes from it
    example_train_steps: int = 2
    example_resume_steps: int = 1
    parity_batch: int = 2            # train_parity: one batch of 2 x 512
    parity_seq: int = 512
    # train: Qwen3-14B cut to train_layers (4 until a run of 978.3 s on one
    # host passed 1,200 s on another; at 4 the phase took 125.3 s, 114.2 s
    # of it the checkpoint's 34.5 GB written and read back, H100 80GB HBM3,
    # 700 W)
    train_layers: int = 2
    train_seq: int = 4096            # configs/shapes.py TRAIN_4K
    train_batch: int = 2
    train_microbatches: int = 2
    train_steps: int = 4
    checkpoint_step: int = 2
    # serve_mla_moe: DeepSeek-V3 at published width, depth cut to 4 (its
    # first_k_dense 3 dense layers and one MoE layer); max_batch,
    # pages_per_seq and max_new as above
    mla_arch: str = "deepseek_v3_671b"
    mla_layers: int = 4
    mla_prompts: tuple = (300, 60, 280, 180, 100, 120)
    mla_pool_frames: int = 4
    # train_moe: Mixtral-8x7B at published width, depth cut to 2; seq,
    # batch, microbatches, steps and the restored step as train
    moe_arch: str = "mixtral_8x7b"
    moe_layers: int = 2
    # serve_danube: H2O-Danube-1.8B at published width and depth, the
    # serve settings above (prompts, batch, context, undersized pool); its
    # ring path at the first danube_ring_layers layers (at 24 it took 61.3
    # s of a 978.3 s run that passed 1,200 s on a slower host; at 12, 48.6
    # s of a 1,049.4 s run, H100 80GB HBM3, 700 W)
    danube_arch: str = "h2o_danube_1_8b"
    danube_ring_layers: int = 6
    # kernels: paged attention at D=80 with Danube's heads and a window
    # shorter than the context, at D=112 with Zamba2-7B's heads
    danube_kernel_window: int = 300
    zamba_arch: str = "zamba2_7b"
    small_page_sizes: tuple = (1, 3, 17)
    # train_mla: DeepSeek-V3 at published width cut to its first_k_dense
    # (3) dense layers; seq, batch and microbatches as train; its parity at
    # one layer, one sequence of mla_parity_seq, f32
    mla_train_layers: int = 3
    mla_train_steps: int = 3
    mla_parity_seq: int = 1024
    # serve_hybrid: Zamba2-7B (zamba_arch) at published width and depth,
    # the serve settings above; the kernel-vs-plain comparison at its
    # first hybrid_plain_layers layers (one group of 6 and a 3-layer tail:
    # one shared-attention site; at 15 layers, two, the side process took
    # 432.4 s of a 1,049.4 s run, as long as the parent's branch beside it,
    # H100 80GB HBM3, 700 W)
    hybrid_plain_layers: int = 9
    # train_hybrid: Zamba2-7B at published width cut to 15 layers (2
    # groups of 6 and a 3-layer tail); seq, batch and microbatches as
    # train; its parity at one group, one sequence of hybrid_parity_seq,
    # f32
    hybrid_train_layers: int = 15
    hybrid_train_steps: int = 3
    hybrid_parity_seq: int = 1024
    # serve_hybrid's engine run at hybrid_serve_layers (2 groups of 6 and
    # the 3-layer tail, the comparison's depth) to keep the whole run inside
    # its time: at 81 layers it took 121.8 s of an 842 s run, at 27 49.9 s
    # of a 978.3 s run that passed 1,200 s on a slower host (H100 80GB
    # HBM3, 700 W)
    hybrid_serve_layers: int = 15
    # serve_encdec: Whisper-medium at published width and depth, its
    # target context of 448 tokens (2 pages of 256) per sequence, an
    # undersized pool of 5 frames against 8; the encoded decode after it:
    # whisper_decode_prompt tokens teacher-forced, then whisper_max_new
    # greedy steps, batch max_batch
    whisper_arch: str = "whisper_medium"
    whisper_max_len: int = 448
    whisper_pool_frames: int = 5
    whisper_prompts: tuple = (4, 48, 112, 224, 16, 160)
    whisper_max_new: int = 16
    whisper_decode_prompt: int = 4
    # train_encdec: tokens (8, 448) in 2 microbatches, 3 steps; its f32
    # parity at whisper_parity_layers encoder and decoder layers, one
    # sequence of 448 over random frames
    whisper_train_batch: int = 8
    whisper_train_steps: int = 3
    whisper_parity_layers: int = 2
    # serve_xlstm: xLSTM-125M at published width and depth, the serve
    # settings (max_batch, the 1,024-token context, prompts, max_new) over
    # an exact-fit pool (it has no KV pages); its f32 token check on the
    # model's first xlstm_check_mlstm mLSTM layers and first sLSTM block
    # (6 layers: the whole first mLSTM run and the block at 5)
    xlstm_arch: str = "xlstm_125m"
    xlstm_check_mlstm: int = 5
    # train_xlstm: published width cut to xlstm_train_layers (an mLSTM
    # layer and the sLSTM block): at 12 layers a step took 55.9-59.1 s and
    # the phase 401 s (H100 80GB HBM3, 700 W; a Python loop over tokens,
    # ~200 k launches a step per 128 tokens); tokens (xlstm_train_batch,
    # xlstm_train_seq) in one microbatch, remat, bf16 params, f32 moments;
    # its f32 parity (card against CPU) at xlstm_parity_layers (sLSTM at
    # 1), one sequence of xlstm_parity_seq; one step profiled at
    # xlstm_profile_seq
    xlstm_train_layers: int = 2
    xlstm_train_batch: int = 4
    xlstm_train_seq: int = 1024
    xlstm_train_steps: int = 3
    xlstm_parity_layers: int = 3
    xlstm_parity_seq: int = 256
    xlstm_profile_seq: int = 64
    # dist_step: Qwen3-14B (arch) at published width cut to dist_layers,
    # the decode at max_batch over pages_per_seq pages, the train step at
    # train_batch x train_seq in train_microbatches
    dist_layers: int = 2
    # dist_families / dist_families_side: the five other families at
    # published width, each cut to (decode layers, train layers) and a
    # train batch x seq in one microbatch: Mixtral at 2 layers over 2 x
    # 4,096 tokens, past GROUP_TOKENS (grouped dispatch); DeepSeek-V3's
    # decode at its 3 dense layers and one MoE layer (22.5 GB of experts),
    # its train at the 3 dense; Zamba2 at one group of 6 (one shared
    # attention site); Whisper at 2 + 2 layers over 1,500 zero frames;
    # xLSTM at an mLSTM layer and the sLSTM block.  Decode at max_batch
    # over pages_per_seq pages (Whisper: its 448-token context)
    dist_family_depth: tuple = (("mixtral_8x7b", 2, 2),
                                ("deepseek_v3_671b", 4, 3),
                                ("zamba2_7b", 6, 6),
                                ("whisper_medium", 2, 2),
                                ("xlstm_125m", 2, 2))
    dist_family_train: tuple = (("mixtral_8x7b", 2, 4096),
                                ("deepseek_v3_671b", 2, 1024),
                                ("zamba2_7b", 2, 512),
                                ("whisper_medium", 2, 448),
                                ("xlstm_125m", 2, 256))


# ------------------------------------------------------------------- helpers
def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(dev, fns, iters: int) -> float:
    """Mean device ms per call over ``iters`` calls cycling through ``fns``
    (each on its own buffers, so a call finds the L2 cold as the model
    does): the summed time of the kernels a call runs, read from
    ``torch.profiler``.  A wrapper's host side can take longer than its
    kernel, so the time between two CUDA events would then measure the
    host; that time is the fallback when the profiler reports no kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for f in fns:
        f()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fns[i % len(fns)]()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    stop.record()
    torch.cuda.synchronize(dev)
    events_ms = start.elapsed_time(stop) / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize(dev)
    kernel_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    EVENTS_MS.append(events_ms)
    return kernel_us / 1e3 / iters if kernel_us > 0 else events_ms


EVENTS_MS: list = []     # the CUDA-event time of every time_ms call, in order


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(a, b, tol: float, what: str) -> float:
    import torch
    require(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape/dtype")
    require(bool(torch.isfinite(a.float()).all()), f"{what}: not finite")
    err = max_err(a, b)
    ok = bool(((a.float() - b.float()).abs()
               <= tol + tol * b.float().abs()).all())
    require(ok, f"{what}: max abs err {err} beyond atol=rtol={tol}")
    return err


def _bound(flops, nbytes, dtype) -> dict:
    """The least time the card could take: the larger of ``flops`` at the
    dtype's peak and ``nbytes`` at HBM's rate.  f32: the tensor cores' rate
    for three TF32 products a product (the f32 route's), with the CUDA
    cores' bound beside it."""
    import torch
    f32 = dtype == torch.float32
    t_ops = (3 * flops / PEAK_FLOPS["tf32"] if f32
             else flops / PEAK_FLOPS[str(dtype).split(".")[-1]])
    t_mem = nbytes / HBM_BYTES_PER_S
    out = {"bound_ms": max(t_ops, t_mem) * 1e3,
           "bound_by": "operations" if t_ops >= t_mem else "bytes",
           "flops": flops, "bytes": nbytes}
    if f32:
        out["bound_cuda_cores_ms"] = max(flops / PEAK_FLOPS["float32"],
                                         t_mem) * 1e3
    return out


#: the flash counters a sequence split moves: the bindings' and their
#: routes' (the bf16 forward, the f32 forward and backward)
SEQ_SPLIT_COUNTERS = ("flash_attention", "flash_attention_bwd",
                      "flash_wgmma_fwd", "flash_f32_fwd", "flash_f32_bwd")


# -------------------------------------------------------------- phase: device
def phase_device(dev):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    import importlib.util
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         ml_dtypes=importlib.util.find_spec("ml_dtypes") is not None)
    return smi


# --------------------------------------------------------------- phase: build
FLASH_TC_KERNELS = ("flash_wgmma_fwd", "flash_wgmma_bwd_dq",
                    "flash_wgmma_bwd_dkdv")
FLASH_F32_KERNELS = ("flash_f32_fwd", "flash_f32_bwd_dq",
                     "flash_f32_bwd_dkdv")


def bwd_instance_kernels(instances) -> list:
    """The bf16 backward's kernels at the instances' head dims: dQ, and
    dK/dV in one pass (template pass 0) or, at 192, a dV pass (1) and a dK
    pass (2)."""
    names = [f"flash_wgmma_bwd_dq<{d}>" for d in instances]
    for d in instances:
        names += ([f"flash_wgmma_bwd_dkdv<{d},1>",
                   f"flash_wgmma_bwd_dkdv<{d},2>"] if d == 192
                  else [f"flash_wgmma_bwd_dkdv<{d},0>"])
    return names


def f32_instance_kernels(instances) -> list:
    """The f32 route's kernels (``csrc/flash_attention.cu``, 3xTF32 on
    wgmma) at the instances' head dims: forward, dQ, and dK/dV in one pass
    (template pass 0) or, at 192, a dV pass (1) and a dK pass (2)."""
    names = [f"flash_f32_fwd<{d}>" for d in instances]
    names += [f"flash_f32_bwd_dq<{d}>" for d in instances]
    for d in instances:
        names += ([f"flash_f32_bwd_dkdv<{d},1>",
                   f"flash_f32_bwd_dkdv<{d},2>"] if d == 192
                  else [f"flash_f32_bwd_dkdv<{d},0>"])
    return names


def _kernel_name(mangled: str) -> str:
    """``flash_wgmma_fwd<128>``, ``flash_wgmma_bwd_dkdv<192,1>`` (head dim,
    pass), ``paged_attention_kernel<bf16,128,5>`` (dtype, head dim, query
    heads a block), ``flash_decode_kernel<bf16,64,1>`` (dtype, head dim,
    query rows a block) or ``flash_bwd_dkdv_sum_kernel`` from the mangled
    name of a kernel
    (``..._GLOBAL__N_115flash_wgmma_fwdILi128EEEv...``)."""
    m = re.search(r"\d+(paged_attention_kernel|flash_decode_kernel)"
                  r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", mangled)
    if m:
        dt = "f32" if m.group(2) == "f" else "bf16"
        return f"{m.group(1)}<{dt},{m.group(3)},{m.group(4)}>"
    m = re.search(r"\d+(flash_\w+?)ILi(\d+)E(?:Li(\d+)E)?", mangled)
    if not m:
        m = re.search(r"\d+(flash_\w+?_kernel)E", mangled)   # no template
        return m.group(1) if m else mangled
    args = ",".join(a for a in m.group(2, 3) if a is not None)
    return f"{m.group(1)}<{args}>"


def _ptxas_by_kernel(log: str) -> dict:
    """ptxas -v resources of each entry function, by kernel name."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = _kernel_name(m.group(1))
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
            out[cur]["ptxas"] = ln.split(":", 1)[-1].strip()
    return out


def _sass_mma_counts(lib_path: str):
    """Tensor-core instructions (HGMMA, HMMA) in each kernel's SASS, read
    with ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for ln in text.splitlines():
        if "Function : " in ln:
            cur = _kernel_name(ln.split("Function : ", 1)[1].strip())
            counts[cur] = {"HGMMA": 0, "HMMA": 0}
        elif cur is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in ln or f" {op} " in ln:
                    counts[cur][op] += 1
    return counts


def _build_fields() -> dict:
    """Build (or load) the kernels' library and check what nvcc made: the
    ``build`` line's fields."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.flash_attention import \
        WGMMA_INSTANCES
    _build.load_library()
    info = _build.BuildInfo
    spills = sum(int(n) for n in
                 re.findall(r"(\d+) bytes spill (?:stores|loads)", info.log))
    resources = _ptxas_by_kernel(info.log)
    if not info.cached:
        wide = [n for n in resources
                if n.startswith("flash_") and "<192" in n]
        require(len(wide) == 8, f"head_dim 192 flash kernels: {wide}")
        decode = [n for n in resources if n.startswith("flash_decode")]
        # bf16: kR 1, 2, 4 at D 16 / 32 / 64 and 1, 2 at 128 / 192; f32:
        # 1, 2, 4, 8 and 1, 2, 4
        require(len(decode) == 31, f"flash_decode kernels: {decode}")
        fwd = [n for n in resources if n.startswith("flash_wgmma_fwd<")]
        require(sorted(fwd) == sorted(f"flash_wgmma_fwd<{d}>"
                                      for d in WGMMA_INSTANCES),
                f"bf16 flash forward instances: {fwd}")
        bwd = [n for n in resources if n.startswith("flash_wgmma_bwd_")]
        require(sorted(bwd) == sorted(bwd_instance_kernels(WGMMA_INSTANCES)),
                f"bf16 flash backward instances: {bwd}")
        f32 = [n for n in resources if n.startswith("flash_f32_")]
        require(sorted(f32) == sorted(f32_instance_kernels(WGMMA_INSTANCES)),
                f"f32 flash instances: {f32}")
        for n in wide + decode + fwd + bwd + f32:
            r = resources[n]
            require(r.get("spill_stores", 0) + r.get("spill_loads", 0) == 0,
                    f"{n} spills: {r.get('ptxas')}")
    mma = _sass_mma_counts(str(info.path))
    if mma is not None:
        for name, c in mma.items():
            resources.setdefault(name, {})["sass_tensor_core_instructions"] = c
        tc = [n for n in mma if n.split("<")[0] in FLASH_TC_KERNELS]
        # the forward's three instances; the backward's dQ at the same
        # three, dK/dV at 64 and 128 and in two passes at 192
        require(sorted(tc) == sorted(
            [f"flash_wgmma_fwd<{d}>" for d in WGMMA_INSTANCES]
            + bwd_instance_kernels(WGMMA_INSTANCES)),
                f"bf16 flash kernels in the SASS: {tc}")
        f32 = [n for n in mma if n.split("<")[0] in FLASH_F32_KERNELS]
        require(sorted(f32) == sorted(f32_instance_kernels(WGMMA_INSTANCES)),
                f"f32 flash kernels in the SASS: {f32}")
        for n in tc + f32:
            # every bf16 and f32 flash kernel is wgmma (HGMMA) alone: no
            # mma.sync (HMMA) left
            require(mma[n]["HGMMA"] > 0 and mma[n]["HMMA"] == 0,
                    f"{n}: HGMMA {mma[n]['HGMMA']}, HMMA {mma[n]['HMMA']}")
    paged = {n: r for n, r in resources.items()
             if n.startswith("paged_attention_kernel<")}
    require(len(paged) == 40, "paged_attention kernels in the build: "
            f"{sorted(paged)}")
    return dict(seconds=round(info.seconds, 3), cached=info.cached,
                library=os.path.basename(str(info.path)),
                sources=[s.name for s in _build.sources()],
                spill_bytes_total=spills,
                f32_flash_instances=f32_instance_kernels(WGMMA_INSTANCES),
                paged_attention={n: {k: r.get(k) for k in ("registers",
                                                           "spill_stores",
                                                           "spill_loads")}
                                 for n, r in sorted(paged.items())},
                sass_read=("cuobjdump -sass" if mma is not None
                           else "not measured (no cuobjdump)"),
                kernels=resources)


def phase_build():
    emit("build", **_build_fields())


# ------------------------------------------------------------- phase: kernels
def _rand(gen, shape, dtype, dev):
    import torch
    return torch.randn(shape, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)


# the cluster sizes split_plan can pick (None: the plan's own choice)
SPLITS = (None, 1, 2, 4, 8)


def _attn_splits(what, q, kp, vp, pt, ln, window=0, tol=None):
    """The paged-attention kernel at every cluster size the plan can pick
    against the plain version on the same inputs; returns the largest
    error."""
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention_kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    ref = paged_attention_ref(q, kp, vp, pt, ln, window=window)
    name = str(q.dtype).split(".")[-1]
    err = 0.0
    for n in SPLITS:
        out = paged_attention_kernel(q, kp, vp, pt, ln, window=window,
                                     n_splits=n)
        sync(q.device)
        err = max(err, check_close(out, ref, tol or TOL[name],
                                   f"{what} n_splits={n}"))
    return err


def _attn_case(gen, dev, B, H, KVH, D, ps, NP, dtype, lengths=None,
               window=0):
    import torch
    P = B * NP
    q = _rand(gen, (B, H, D), dtype, dev)
    kp = _rand(gen, (P, ps, KVH, D), dtype, dev)
    vp = _rand(gen, (P, ps, KVH, D), dtype, dev)
    if lengths is None:
        lengths = [max(1, round(1 + i * (NP * ps - 1) / max(1, B - 1)))
                   for i in range(B)]
    pt = torch.arange(P, dtype=torch.int32, device=dev).reshape(B, NP)
    ln = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
    name = str(dtype).split(".")[-1]
    return _attn_splits(f"paged_attention B{B} H{H} KVH{KVH} D{D} ps{ps} "
                        f"NP{NP} {name} window={window}", q, kp, vp, pt, ln,
                        window)


ROW_FLOOR = 5e-4      # bf16 row check: reference rows' rms floored here


def _row_rel_err(a, b) -> float:
    """The largest relative L2 error of one row (the last axis: one
    position of one head) of ``a`` against the same row of ``b``, the
    reference row's norm floored at ``ROW_FLOOR`` x sqrt(row length): a
    row whose reference is 0 in exact arithmetic (the first query's dq,
    which sees one key) holds f32 rounding noise on both sides."""
    a, b = a.float(), b.float()
    floor = ROW_FLOOR * math.sqrt(b.shape[-1])
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(floor))
                 .max())


def _flash_close(a, b, grad: bool, what: str) -> tuple:
    """f32: element-wise, atol = rtol = 2e-5 (forward) or 1e-4 (gradients).
    bf16: every row within 2e-2 of its reference row in relative L2 norm,
    so that each position is held to its own scale (late rows of a causal
    output and the gradients of late keys are 10-1000x smaller than the
    tensor's largest entry).  Returns (max abs err, max row relative err)."""
    import torch
    if a.dtype == torch.float32:
        err = check_close(a, b, GRAD_TOL_F32 if grad else TOL["float32"], what)
        return err, _row_rel_err(a, b)
    require(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape/dtype")
    require(bool(torch.isfinite(a.float()).all()), f"{what}: not finite")
    rel = _row_rel_err(a, b)
    require(rel <= TOL["bfloat16"], f"{what}: a row's relative L2 error "
            f"{rel} beyond {TOL['bfloat16']}")
    return max_err(a, b), rel


def _flash_case(gen, dev, B, S, H, KVH, D, dtype, causal, window,
                fused=False, Sk=None, q_offset=None):
    """Forward and gradients of the kernels against the plain version on
    the card.  ``fused``: q, k and v are strided views of one
    (B, S, H + 2 KVH, D) tensor, as a fused QKV projection gives them (with
    ``Sk`` != S, cross-attention: q a view of a (B, S, H + KVH, D) tensor,
    k and v views of one (B, Sk, 2 KVH, D), a fused KV projection's).
    f32: the gradients against autograd of the plain forward.
    bf16: row by row against the plain backward given the kernel's own
    rounded output (the backward's rowsum(dO * O) takes O in bf16, which
    moves dq by up to 2^-8 of its terms: where the softmax is peaked that
    is more than 2e-2 of dq's row), and against autograd within 2e-2 x
    max|ref|.  ``q_offset``: q's rows at that absolute position (a causal
    mask or a window at Sq != Sk).  Returns (fwd, grad) x (max abs err,
    max row relative err)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    Sk = Sk or S
    off = dict(q_offset=q_offset or 0)
    if fused and Sk == S:
        qkv = _rand(gen, (B, S, H + 2 * KVH, D), dtype, dev)
        q, k, v = qkv.requires_grad_(True).split([H, KVH, KVH], dim=2)
    elif fused:
        qx = _rand(gen, (B, S, H + KVH, D), dtype, dev).requires_grad_(True)
        kv = _rand(gen, (B, Sk, 2 * KVH, D), dtype, dev).requires_grad_(True)
        q = qx[:, :, :H]
        k, v = kv.split([KVH, KVH], dim=2)
    else:
        q = _rand(gen, (B, S, H, D), dtype, dev).requires_grad_(True)
        k = _rand(gen, (B, Sk, KVH, D), dtype, dev).requires_grad_(True)
        v = _rand(gen, (B, Sk, KVH, D), dtype, dev).requires_grad_(True)
    dout = _rand(gen, (B, S, H, D), dtype, dev)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    got = torch.autograd.grad(out, (q, k, v), dout)
    sync(dev)
    t = [x.detach().transpose(1, 2) for x in (q, k, v, out, dout)]
    ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, **off).transpose(1, 2)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    name = str(dtype).split(".")[-1]
    what = (f"flash_attention B{B} Sq{S} Sk{Sk} H{H} KVH{KVH} D{D} {name} "
            f"causal={causal} window={window} fused={fused} "
            f"q_offset={q_offset}")
    e_fwd = _flash_close(out, ref, False, what)
    if dtype == torch.float32:
        e_grad = [_flash_close(a, b, True, f"{what} d{n}")
                  for a, b, n in zip(got, want, "qkv")]
        return e_fwd, tuple(max(e[i] for e in e_grad) for i in range(2))
    plain = [x.transpose(1, 2) for x in flash_attention_bwd_ref(
        *t, causal=causal, window=window, **off)]
    rel = max(_flash_close(a, b, True, f"{what} d{n}, plain backward")[1]
              for a, b, n in zip(got, plain, "qkv"))
    err = max(_close_max(a, b, f"{what} d{n}")
              for a, b, n in zip(got, want, "qkv"))
    return e_fwd, (err, rel)


def _close_max(a, b, what: str) -> float:
    """bf16 gradients against autograd: max |a - b| within 2e-2 x max|b|,
    max|b| floored at ``ROW_FLOOR`` as the row check floors a row's norm: a
    gradient that is 0 in exact arithmetic (dq when every row sees one key,
    Sk = 1) holds f32 rounding noise on both sides."""
    err = max_err(a, b)
    scale = max(float(b.float().abs().max()), ROW_FLOOR)
    require(err <= TOL["bfloat16"] * scale, f"{what}: max abs err {err} "
            f"beyond {TOL['bfloat16']} x max|ref| = {TOL['bfloat16'] * scale}")
    return err


def _flash_f32_shape(gen, dev, name: str, B, S, H, KVH, D, it: int) -> dict:
    """One f32 causal shape on the f32 route (3xTF32 on wgmma): forward and
    gradients held element by element against the plain version (atol =
    rtol = 2e-5 forward, 1e-4 gradients), the backward's two calls
    bit-identical (the per-head dK/dV terms summed in one order), and
    kernel / plain / SDPA device ms beside the bound at the tensor cores'
    rate for three TF32 products and the one at the f32 CUDA-core rate.
    The plain version's products are true f32: TF32 matmuls are off."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32,
            "TF32 matmuls are on: the f32 plain version is no yardstick")
    f32 = torch.float32
    q = _rand(gen, (B, S, H, D), f32, dev).requires_grad_(True)
    k = _rand(gen, (B, S, KVH, D), f32, dev).requires_grad_(True)
    v = _rand(gen, (B, S, KVH, D), f32, dev).requires_grad_(True)
    dout = _rand(gen, (B, S, H, D), f32, dev)
    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v)
        got = flash_attention_bwd(q, k, v, o, lse, dout)
        again = flash_attention_bwd(q, k, v, o, lse, dout)
    sync(dev)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    require(same, f"flash_attention_bwd {name} f32: two calls differ")
    del again
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ref = flash_attention_ref(qt, kt, vt).transpose(1, 2)
    want = torch.autograd.grad(ref, (q, k, v), dout, retain_graph=True)
    what = f"flash_attention {name} B{B} S{S} H{H} KVH{KVH} D{D} float32"
    e_fwd = _flash_close(o, ref.detach(), False, what)
    e_grad = [_flash_close(a, b, True, f"{what} d{n}")
              for a, b, n in zip(got, want, "qkv")]
    del got, want
    pairs = B * S * (S + 1) // 2
    fwd_flops, bwd_flops = 4 * H * D * pairs, 10 * H * D * pairs
    fwd_bytes = 4 * (2 * B * S * H * D + 2 * B * S * KVH * D) + 4 * B * H * S
    bwd_bytes = 4 * (6 * B * S * H * D + 4 * B * S * KVH * D) + 4 * B * H * S

    def bound(flops, nbytes):
        return _bound(flops, nbytes, f32)

    plain_it = max(2, it // 3)
    with torch.no_grad():
        fwd_ms = time_ms(dev, [lambda: flash_attention_fwd(q, k, v)], it)
        bwd_ms = time_ms(dev, [lambda: flash_attention_bwd(
            q, k, v, o, lse, dout)], it)
        plain_fwd_ms = time_ms(dev, [lambda: flash_attention_ref(
            qt, kt, vt)], plain_it)
        sdpa_fwd_ms = time_ms(dev, [lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)], it)
    plain_bwd_ms = time_ms(dev, [lambda: torch.autograd.grad(
        ref, (q, k, v), dout, retain_graph=True)], plain_it)
    del ref
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    sdpa_bwd_ms = time_ms(dev, [lambda: torch.autograd.grad(
        lib, (q, k, v), dout.transpose(1, 2), retain_graph=True)], it)
    del lib, q, k, v, o, lse, dout, qt, kt, vt
    sync(dev)
    torch.cuda.empty_cache()
    return {"shape": {"B": B, "S": S, "H": H, "KVH": KVH, "D": D,
                      "dtype": "float32", "causal": True},
            "errs": e_fwd + tuple(max(e[i] for e in e_grad)
                                  for i in range(2)),
            "backward_bit_identical_over_two_calls": same,
            "fwd": {"ms": fwd_ms, "plain_ms": plain_fwd_ms,
                    "library_ms": sdpa_fwd_ms, "max_abs_err": e_fwd[0],
                    **bound(fwd_flops, fwd_bytes)},
            "bwd": {"ms": bwd_ms, "plain_ms": plain_bwd_ms,
                    "library_ms": sdpa_bwd_ms,
                    "max_abs_err": max(e[0] for e in e_grad),
                    **bound(bwd_flops, bwd_bytes)}}


def _f32_edges(gen, dev) -> dict:
    """The f32 route at its edges (``F32_EDGE_CASES``): forward and
    gradients through ``ops.flash_attention`` against the plain version
    (``_flash_case``: element-wise, 2e-5 forward, 1e-4 gradients), then the
    backward kernels twice on one set of inputs, whose bits must agree."""
    import torch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    keys = ("fwd_abs", "fwd_row_rel", "grad_abs", "grad_row_rel")
    err = dict.fromkeys(keys, 0.0)
    f32 = torch.float32
    for B, Sq, Sk, H, KVH, D, causal, window, q_offset, *fused in \
            F32_EDGE_CASES:
        e = _flash_case(gen, dev, B, Sq, H, KVH, D, f32, causal, window,
                        bool(fused), Sk=Sk, q_offset=q_offset)
        err = {k: max(err[k], x) for k, x in zip(keys, e[0] + e[1])}
        q, dout = (_rand(gen, (B, Sq, H, D), f32, dev) for _ in range(2))
        k, v = (_rand(gen, (B, Sk, KVH, D), f32, dev) for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        a = flash_attention_bwd(q, k, v, o, lse, dout, **kw)
        b = flash_attention_bwd(q, k, v, o, lse, dout, **kw)
        sync(dev)
        require(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"flash_attention_bwd f32 B{B} Sq{Sq} Sk{Sk} H{H} KVH{KVH} "
                f"D{D}: two calls differ")
    return {"cases": len(F32_EDGE_CASES), "max_abs_err": err,
            "backward_bit_identical_over_two_calls": True}


def _tile_fwd(q, k, v, causal: bool = False):
    """The dtype's tile-kernel forward (``flash_attention_wgmma.cu`` in
    bf16, ``flash_attention.cu`` in f32) at any Sq, the decode route bypassed:
    the yardstick of the route's gain at a few-row shape.  Not counted."""
    import torch
    from repro_torch.kernels._build import check_launch, load_library
    from repro_torch.kernels.flash_attention.flash_attention import route
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    code = getattr(load_library(), route(q.dtype, D).fwd)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, H, KVH, D, *q.stride()[:3],
        *k.stride()[:3], int(causal), 0, 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "tile forward")
    return o, lse


def _decode_fwd(q, k, v, causal: bool, window: int, q_offset, n: int):
    """The decode kernel's C entry at a cluster of ``n`` blocks, the plan
    and the route bypassed (any Sq): the checks' and sweeps' way to reach
    every cluster size.  Not counted."""
    import torch
    from repro_torch.kernels._build import check_launch, load_library
    from repro_torch.kernels.flash_attention import flash_attention as fa
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    code = load_library().repro_flash_decode_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, H, KVH, D, *q.stride()[:3],
        *k.stride()[:3], int(causal), int(window), int(q_offset or 0), n,
        fa._DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "decode forward")
    return o, lse


def _decode_check(gen, dev, B, Sq, Sk, H, KVH, D, dtype, causal, window,
                  q_offset) -> dict:
    """The decode kernel (``csrc/flash_decode.cu``) at one few-row shape
    against the plain version, through the binding (its plan's cluster
    size) and at every cluster size (1, 2, 4, 8, ``_decode_fwd``): o by
    ``_flash_close``, lse within 1e-4 x max(1, |lse|) of
    ``flash_attention_split_ref`` at one share; two calls bit-identical at
    each size."""
    import torch
    from repro_torch.kernels.flash_attention.flash_attention import (
        DECODE, flash_attention_fwd, forward_entry)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, flash_attention_split_ref)
    require(forward_entry(dtype, D, Sq) == DECODE, f"Sq {Sq}: not decode")
    q = _rand(gen, (B, Sq, H, D), dtype, dev)
    k, v = (_rand(gen, (B, Sk, KVH, D), dtype, dev) for _ in range(2))
    kw = dict(causal=causal, window=window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ref = flash_attention_ref(qt, kt, vt, q_offset=q_offset or 0,
                              **kw).transpose(1, 2)
    lse_ref = flash_attention_split_ref(qt.float(), kt.float(), vt.float(),
                                        q_offset=q_offset or 0, **kw)[1]
    what = (f"flash_decode B{B} Sq{Sq} Sk{Sk} H{H} KVH{KVH} D{D} "
            f"{str(dtype).split('.')[-1]} causal={causal} window={window} "
            f"q_offset={q_offset}")
    errs = {"max_abs_err": 0.0, "row_rel_err": 0.0, "lse_err": 0.0}
    for n in (None, 1, 2, 4, 8):
        if n is None:
            o, lse = flash_attention_fwd(q, k, v, q_offset=q_offset, **kw)
            o2, lse2 = flash_attention_fwd(q, k, v, q_offset=q_offset, **kw)
        else:
            o, lse = _decode_fwd(q, k, v, causal, window, q_offset, n)
            o2, lse2 = _decode_fwd(q, k, v, causal, window, q_offset, n)
        sync(dev)
        e = _flash_close(o, ref, False, f"{what} n_splits={n}")
        le = float((lse - lse_ref).abs().max())
        require(le <= 1e-4 * max(1.0, float(lse_ref.abs().max())),
                f"{what} n_splits={n}: lse err {le}")
        require(torch.equal(o, o2) and torch.equal(lse, lse2),
                f"{what} n_splits={n}: two calls differ")
        errs = {"max_abs_err": max(errs["max_abs_err"], e[0]),
                "row_rel_err": max(errs["row_rel_err"], e[1]),
                "lse_err": max(errs["lse_err"], le)}
    return errs


DECODE_CASES = [
    # B, Sq, Sk, H, KVH, D, causal, window, q_offset: few-row calls, the
    # masked ones at a query offset (a chunk of decode, a rank's last rows)
    (2, 3, 700, 16, 4, 128, True, 0, 697),      # G = 4, causal
    (1, 8, 900, 16, 4, 64, True, 100, 300),     # a window inside the keys
    (1, 5, 333, 24, 2, 128, True, 40, 200),     # G = 12: 60 rows, 15 groups
    (2, 2, 65, 4, 4, 16, False, 30, 20),        # non-causal window
    (1, 4, 400, 8, 2, 192, True, 0, 396),       # MLA's head dim
    (3, 1, 1500, 32, 8, 80, False, 0, None),    # Danube's heads over frames
    (2, 1, 257, 8, 8, 112, False, 0, None),     # Zamba2's head dim
    (1, 7, 5, 4, 1, 32, False, 0, None),        # Sq > Sk
]
# the training example's flash call (examples/torch_train_demand_paged.py
# at its defaults: a batch of 8 in two microbatches, 64 tokens, 8 / 4
# heads of 64, f32): B, S, H, KVH, D
EXAMPLE_F32 = (4, 64, 8, 4, 64)
# the f32 route's own edges (csrc/flash_attention.cu: 64-row blocks, key
# tiles of 64 or 32, q tiles of 64 or 32 in dK/dV, lse and delta copied
# from the aligned element before a tile's first): B, Sq, Sk, H, KVH, D,
# causal, window, q_offset[, fused]
F32_EDGE_CASES = [
    (1, 130, 130, 4, 1, 64, True, 0, None),      # Sq % 4 = 2, KVH = 1
    (2, 333, 333, 8, 2, 128, True, 0, None),     # Sq a multiple of neither
    (1, 93, 1536, 24, 2, 128, True, 0, 207),     # an offset inside a tile
    (1, 97, 700, 8, 1, 192, True, 100, 301),     # ... a window, KVH = 1
    (2, 66, 66, 6, 1, 80, False, 0, None, True),  # views, KVH = 1
    (1, 9, 9, 4, 4, 16, True, 0, None),          # the fewest tile rows
    (2, 77, 129, 8, 2, 112, False, 0, None, True),  # cross, views
]
DECODE_GRAD_CASES = [
    # B, Sq, Sk, H, KVH, D, causal, window, q_offset: a decode-route
    # forward, then the backward kernels, against the plain gradients
    (2, 3, 700, 16, 4, 128, True, 0, 697),
    (1, 8, 900, 16, 4, 64, True, 100, 300),
    (2, 2, 65, 4, 4, 16, False, 30, 20),
]


FLASH_CASES = [
    # B, S, H, KVH, D, causal, window[, fused]: S ragged against the tiles
    # (64 and 128 rows)
    (1, 100, 4, 4, 16, True, 0),        # G = 1
    (2, 130, 10, 2, 64, True, 0),       # G = 5
    (1, 150, 10, 2, 80, True, 40),      # window, h2o-danube's head_dim
    (1, 77, 4, 4, 128, False, 0),       # non-causal
    (1, 200, 10, 2, 128, True, 70),     # window, Qwen3's head_dim
    (2, 96, 5, 1, 16, False, 0),        # G = 5, non-causal
    (2, 300, 10, 2, 128, True, 0, True),  # q, k, v strided views of one qkv
    (1, 700, 8, 2, 80, True, 200),      # h2o-danube's D and G, window
                                        # edges inside several tiles
    (1, 600, 32, 8, 128, True, 256),    # Mixtral-8x7B's heads (G = 4),
                                        # a window inside the sequence
    (1, 333, 8, 2, 192, True, 0),       # DeepSeek-V3's MLA head_dim, GQA
    (2, 150, 4, 4, 192, True, 40),      # ... with a window
    (1, 260, 4, 4, 192, False, 0),      # ... non-causal
    (1, 190, 4, 4, 112, True, 0),       # Zamba2-7B's head_dim, G = 1
]

CROSS_CASES = [
    # B, Sq, Sk, H, KVH, D, fused: cross-attention (Sq != Sk, non-causal,
    # no window), Whisper-medium's heads (16 of 64) and another served
    # head dim; Sq ragged against every tile (64, 128 rows), Sq > Sk too
    (2, 1, 1500, 16, 16, 64, False),    # decode: one row over the frames
    (2, 7, 33, 16, 4, 64, True),        # G = 4, q / k / v as views
    (1, 65, 130, 8, 2, 128, False),     # G = 4, D = 128
    (2, 448, 1500, 16, 16, 64, True),   # the training cross shape, views
    (1, 65, 1, 4, 4, 64, False),        # Sq > Sk = 1
    (1, 448, 33, 8, 2, 128, False),     # Sq > Sk, G = 4, D = 128
    (3, 1, 130, 8, 8, 128, False),      # decode at D = 128
    (1, 7, 1500, 16, 4, 64, False),     # G = 4 over the frames
]


# the bf16 kernels (csrc/flash_attention_wgmma.cu forward and
# csrc/flash_attention_wgmma_bwd.cu backward) at every supported head dim
# and at their edges, forward and gradients through ops.flash_attention
# against the plain version (``_flash_case``): B, Sq, Sk, H, KVH, D,
# causal, window, q_offset, fused (q, k, v views of one projection)
WGMMA_CASES = [
    *[(1, 333, None, 4, 2, D, True, 0, None, False)     # Sq, Sk no multiple
      for D in (16, 32, 48, 64, 80, 96, 112, 128, 192)],   # of 64 or 128
    (1, 9, None, 8, 2, 64, True, 0, None, False),       # just past decode
    (1, 4500, None, 32, 8, 128, True, 4096, None, False),   # Mixtral's heads,
                                                        # its window biting
    (2, 448, 1500, 16, 16, 64, False, 0, None, True),   # Whisper's cross
    (1, 256, 4096, 40, 8, 128, True, 0, 2048, False),   # a rank's rows, an
                                                        # offset on a tile
    (1, 300, 1000, 8, 2, 128, True, 0, 517, False),     # an offset off the
    (2, 200, 777, 8, 2, 80, True, 300, 333, False),     # tiles, a window
    (1, 150, 700, 4, 4, 192, True, 0, 550, False),      # D = 192's 64-key
    (1, 333, None, 8, 1, 112, False, 0, None, True),    # tiles; KVH = 1
]
# two calls of the bf16 forward and of its backward at each instance (B, S,
# H, KVH, D, window)
WGMMA_REPEAT = [(2, 700, 8, 2, 48, 0), (1, 1000, 8, 2, 112, 300),
                (1, 600, 4, 4, 192, 0)]


def _wgmma_checks(gen, dev) -> dict:
    """The bf16 forward and backward at ``WGMMA_CASES`` (``_flash_case``:
    forward and gradients against the plain version, bf16 rows within
    2e-2), ``WGMMA_REPEAT`` (two calls give identical o and lse bits, and
    two backward calls identical dq, dk and dv) and ``_bwd_views`` (the
    backward reads the reference signature's views as it reads contiguous
    tensors).  Returns the largest errors and the count of cases."""
    import torch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    keys = ("fwd_abs", "fwd_row_rel", "grad_abs", "grad_row_rel")
    errs = dict.fromkeys(keys, 0.0)
    for (B, Sq, Sk, H, KVH, D, causal, window, off, fused) in WGMMA_CASES:
        e = _flash_case(gen, dev, B, Sq, H, KVH, D, torch.bfloat16, causal,
                        window, fused=fused, Sk=Sk, q_offset=off)
        errs = {k: max(errs[k], x) for k, x in zip(keys, e[0] + e[1])}
        sync(dev)
        torch.cuda.empty_cache()
    for (B, S, H, KVH, D, window) in WGMMA_REPEAT:
        q = _rand(gen, (B, S, H, D), torch.bfloat16, dev)
        k, v = (_rand(gen, (B, S, KVH, D), torch.bfloat16, dev)
                for _ in range(2))
        o, lse = flash_attention_fwd(q, k, v, window=window)
        o2, lse2 = flash_attention_fwd(q, k, v, window=window)
        sync(dev)
        require(torch.equal(o, o2) and torch.equal(lse, lse2),
                f"flash_wgmma_fwd B{B} S{S} H{H} KVH{KVH} D{D} "
                f"window={window}: two calls differ")
        dout = _rand(gen, (B, S, H, D), torch.bfloat16, dev)
        g = flash_attention_bwd(q, k, v, o, lse, dout, window=window)
        g2 = flash_attention_bwd(q, k, v, o, lse, dout, window=window)
        sync(dev)
        require(all(torch.equal(a, b) for a, b in zip(g, g2)),
                f"flash_wgmma_bwd B{B} S{S} H{H} KVH{KVH} D{D} "
                f"window={window}: two calls differ")
    views = _bwd_views(gen, dev)
    return {"max_abs_err": errs, "cases": len(WGMMA_CASES),
            "bit_identical_over_two_calls": len(WGMMA_REPEAT),
            "backward_bit_identical_over_two_calls": len(WGMMA_REPEAT),
            "backward_reference_signature_views": views}


def _bwd_views(gen, dev) -> dict:
    """The bf16 backward given q, k, v, o and dout as the reference
    signature's (B, H, S, D) tensors viewed in the model layout (read
    through their strides) against the same values made contiguous: the
    same bits, and within the plain version's rows (``_flash_close``)."""
    import torch
    from repro_torch.kernels.flash_attention.flash_attention import (
        _rows_aligned, flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    B, H, KVH, S, D = 2, 8, 2, 300, 64
    bf16 = torch.bfloat16
    q = _rand(gen, (B, H, S, D), bf16, dev).transpose(1, 2)
    k, v = (_rand(gen, (B, KVH, S, D), bf16, dev).transpose(1, 2)
            for _ in range(2))
    dout = _rand(gen, (B, H, S, D), bf16, dev).transpose(1, 2)
    o, lse = flash_attention_fwd(q, k, v, window=100)
    o = o.transpose(1, 2).contiguous().transpose(1, 2)
    views = (q, k, v, o, dout)
    require(all(map(_rows_aligned, views))
            and not any(t.is_contiguous() for t in views),
            "flash_attention_bwd views: not the reference signature's")
    got = flash_attention_bwd(q, k, v, o, lse, dout, window=100)
    want = flash_attention_bwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), o.contiguous(), lse,
                               dout.contiguous(), window=100)
    sync(dev)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    require(same, "flash_attention_bwd: strided views give other bits than "
            "contiguous tensors")
    plain = [x.transpose(1, 2) for x in flash_attention_bwd_ref(
        *(t.transpose(1, 2) for t in (q, k, v, o, dout)), window=100)]
    rel = max(_flash_close(a, b, True, f"flash_attention_bwd views d{n}")[1]
              for a, b, n in zip(got, plain, "qkv"))
    return {"bit_identical_to_contiguous": same, "row_rel_err": rel}


def _cross_refused(gen, dev) -> int:
    """A CUDA call with Sq != Sk and a causal mask or a window raises
    ``ValueError`` before any launch (forward and, through autograd's
    forward, the training path).  Returns the cases checked."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import flash_attention
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        q = _rand(gen, (1, 7, 4, 64), dt, dev)
        k = _rand(gen, (1, 33, 4, 64), dt, dev)
        for causal, window in ((True, 0), (False, 16), (True, 16)):
            before = kernels.launch_counts()["flash_attention"]
            try:
                flash_attention(q, k, k, causal=causal, window=window)
                raised = False
            except ValueError:
                raised = True
            require(raised and kernels.launch_counts()["flash_attention"]
                    == before, f"flash_attention Sq 7 != Sk 33 {dt} "
                    f"causal={causal} window={window} did not raise")
            n += 1
    return n


def _flash_bf16_shape(gen, dev, B, S, H, KVH, D, it: int, Sk=None,
                      causal: bool = True, backward: bool = True) -> dict:
    """One bf16 shape (causal, or S query rows over ``Sk`` keys without a
    mask): the kernels' forward and backward against the plain version
    (rows) and autograd of it (2e-2 x max|ref|); kernel / plain / SDPA
    device ms; FLOPs, bytes and the bound.  Seven time_ms calls, in the
    order of ``FLASH_TIMED``; with ``backward=False`` (a decode shape) the
    forward's four, in the order of ``FLASH_TIMED_FWD`` (the last the tile
    kernel's, ``_tile_fwd``), with its lse against the plain one, two calls
    bit-identical, the kernel that ran and its cluster size."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    bf16 = torch.bfloat16
    Sk = Sk or S
    what = (f"flash_attention B{B} Sq{S} Sk{Sk} H{H} KVH{KVH} D{D} bf16 "
            f"causal={causal}")
    q = _rand(gen, (B, S, H, D), bf16, dev).requires_grad_(True)
    k = _rand(gen, (B, Sk, KVH, D), bf16, dev).requires_grad_(True)
    v = _rand(gen, (B, Sk, KVH, D), bf16, dev).requires_grad_(True)
    dout = _rand(gen, (B, S, H, D), bf16, dev)
    el = 2                                        # bf16 bytes
    pairs = S * (S + 1) // 2 if causal else S * Sk    # (q, k) pairs
    fwd_flops = 4 * B * H * D * pairs             # QK^T and PV
    fwd_bytes = el * (2 * B * S * H * D + 2 * B * Sk * KVH * D) \
        + 4 * B * H * S

    def bound(flops, nbytes):
        t_ops = flops / PEAK_FLOPS["bfloat16"]
        t_mem = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_mem) * 1e3, \
            "operations" if t_ops >= t_mem else "bytes"

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not backward:
        from repro_torch.kernels.flash_attention import \
            flash_attention as fa
        from repro_torch.kernels.flash_attention.ref import \
            flash_attention_split_ref
        entry = fa.forward_entry(q.dtype, D, S)
        with torch.no_grad():
            o, lse = flash_attention_fwd(q, k, v, causal=causal)
            o2, lse2 = flash_attention_fwd(q, k, v, causal=causal)
            sync(dev)
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            require(same, f"{what}: two calls differ")
            ref = flash_attention_ref(qt, kt, vt, causal=causal)
            err_fwd, rel_fwd = _flash_close(o, ref.transpose(1, 2), False,
                                            what)
            lse_ref = flash_attention_split_ref(
                qt.float(), kt.float(), vt.float(), causal=causal)[1]
            lse_err = float((lse - lse_ref).abs().max())
            require(lse_err <= 1e-4 * max(1.0, float(lse_ref.abs().max())),
                    f"{what}: lse err {lse_err}")
            fwd_ms = time_ms(dev, [lambda: flash_attention_fwd(
                q, k, v, causal=causal)], it)
            plain_fwd_ms = time_ms(dev, [lambda: flash_attention_ref(
                qt, kt, vt, causal=causal)], it)
            sdpa_fwd_ms = time_ms(dev, [lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)], it)
            tile_ms = time_ms(dev, [lambda: _tile_fwd(q, k, v, causal)], it)
        fb, fby = bound(fwd_flops, fwd_bytes)
        n_splits = fa.plan_decode_splits(
            dev.index or 0, B, KVH, (H // KVH) * S, D,
            fa.decode_tiles(S, Sk, causal, 0, None,
                            fa.DECODE_TILE_ROWS[q.dtype]), q.dtype) \
            if entry == fa.DECODE else None
        del q, k, v, o, o2, lse, lse2, ref, dout
        return {"shape": {"B": B, "Sq": S, "Sk": Sk, "H": H, "KVH": KVH,
                          "D": D, "dtype": "bfloat16", "causal": causal},
                "errs": (err_fwd, rel_fwd),
                "fwd": {"ms": fwd_ms, "plain_ms": plain_fwd_ms,
                        "bound_ms": fb, "bound_by": fby,
                        "library_ms": sdpa_fwd_ms, "flops": fwd_flops,
                        "bytes": fwd_bytes, "bound_share": fb / fwd_ms,
                        "max_abs_err": err_fwd, "lse_err": lse_err,
                        "kernel": entry, "n_splits": n_splits,
                        "bit_identical_over_two_calls": same,
                        "tile_kernel_ms": tile_ms}}
    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, dout,
                                         causal=causal)
    sync(dev)
    ref = flash_attention_ref(qt, kt, vt, causal=causal).transpose(1, 2)
    err_fwd, rel_fwd = _flash_close(o, ref.detach(), False, what)
    want = torch.autograd.grad(ref, (q, k, v), dout, retain_graph=True)
    err_bwd = max(_close_max(a, b, f"{what} d{n}")
                  for a, b, n in zip((dq, dk, dv), want, "qkv"))
    del want
    with torch.no_grad():
        plain = [x.transpose(1, 2) for x in flash_attention_bwd_ref(
            qt, kt, vt, o.transpose(1, 2), dout.transpose(1, 2),
            causal=causal)]
    rel_bwd = max(_flash_close(a, b, True, f"{what} d{n}, plain backward")[1]
                  for a, b, n in zip((dq, dk, dv), plain, "qkv"))
    del plain, dq, dk, dv
    with torch.no_grad():
        fwd_ms = time_ms(dev, [lambda: flash_attention_fwd(
            q, k, v, causal=causal)], it)
        bwd_ms = time_ms(dev, [lambda: flash_attention_bwd(
            q, k, v, o, lse, dout, causal=causal)], it)
        plain_fwd_ms = time_ms(dev, [lambda: flash_attention_ref(
            qt, kt, vt, causal=causal)], max(2, it // 3))
    plain_bwd_ms = time_ms(dev, [lambda: torch.autograd.grad(
        ref, (q, k, v), dout, retain_graph=True)], max(2, it // 3))
    del ref
    sync(dev)
    torch.cuda.empty_cache()
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(dev, [lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)], it)
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    sdpa_bwd_ms = time_ms(dev, [lambda: torch.autograd.grad(
        lib, (q, k, v), dout.transpose(1, 2), retain_graph=True)], it)
    del lib

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
        torch.autograd.grad(out, (q, k, v), dout.transpose(1, 2))

    sdpa_fwd_bwd_ms = time_ms(dev, [sdpa_fwd_bwd], it)
    bwd_flops = 10 * B * H * D * pairs            # S, dP, dV, dK, dQ
    bwd_bytes = el * (6 * B * S * H * D + 4 * B * Sk * KVH * D) \
        + 4 * B * H * S

    fb, fby = bound(fwd_flops, fwd_bytes)
    bb, bby = bound(bwd_flops, bwd_bytes)
    del q, k, v, o, lse, dout
    sync(dev)
    torch.cuda.empty_cache()
    seq = {"S": S} if Sk == S else {"Sq": S, "Sk": Sk}
    return {"shape": {"B": B, **seq, "H": H, "KVH": KVH, "D": D,
                      "dtype": "bfloat16", "causal": causal},
            "errs": (err_fwd, rel_fwd, err_bwd, rel_bwd),
            "fwd": {"ms": fwd_ms, "plain_ms": plain_fwd_ms, "bound_ms": fb,
                    "bound_by": fby, "library_ms": sdpa_fwd_ms,
                    "flops": fwd_flops, "bytes": fwd_bytes,
                    "tflops_per_s": fwd_flops / fwd_ms / 1e9,
                    "max_abs_err": err_fwd},
            "bwd": {"ms": bwd_ms, "plain_ms": plain_bwd_ms, "bound_ms": bb,
                    "bound_by": bby, "library_ms": sdpa_bwd_ms,
                    "library_fwd_bwd_ms": sdpa_fwd_bwd_ms,
                    "flops": bwd_flops, "bytes": bwd_bytes,
                    "tflops_per_s": bwd_flops / bwd_ms / 1e9,
                    "max_abs_err": err_bwd}}


FLASH_TIMED = ("flash_attention", "flash_attention_bwd",
               "flash_attention_plain", "flash_attention_plain_bwd", "sdpa",
               "sdpa_bwd", "sdpa_fwd_bwd")
FLASH_TIMED_FWD = ("flash_attention", "flash_attention_plain", "sdpa",
                   "flash_attention_tile_kernel")
FLASH_TIMED_F32 = ("flash_attention", "flash_attention_bwd",
                   "flash_attention_plain", "sdpa",
                   "flash_attention_plain_bwd", "sdpa_bwd")


# the bf16 route at q_offset = 0 (B, S, H, KVH, D, causal, window); in f32
# the same cases hold the CUDA-core route's bits (tools/flash_bits_check.py)
BF16_BITS_CASES = ((1, 700, 8, 2, 128, True, 0),
                   (2, 333, 4, 4, 64, True, 100),
                   (1, 300, 8, 8, 192, False, 0))
# sha256 of those outputs from the bf16 kernels (the wgmma forward of
# flash_attention_wgmma.cu, the wgmma backward of
# flash_attention_wgmma_bwd.cu; python3 tools/flash_bits_check.py
# --parent DIR on the NVIDIA H100 80GB HBM3, torch 2.11.0+cu128, with DIR
# the tree before the wgmma backward, whose f32 bits and forward bits this
# tree keeps): the same inputs must give the same bits.  BF16_FWD_BITS
# covers o and lse alone, BF16_BITS o, lse, dq, dk and dv.  A change meant
# to move the bf16 kernels' bits (or a torch whose CUDA RNG draws
# differently) fails here until it writes the tool's new digests, taken
# against its parent tree, into them
BF16_FWD_BITS = \
    "fb81f71b568976470c9cd2860dc2089b3f9128edcf7b0e7f5ff1440b0fb2d927"
BF16_BITS = "b8e7a9c8fd9f302f768c05ce50d5533f7f63824c043abc6bc5a7b84e26f85d3a"


def bf16_bits(dev, fwd, bwd, dtype=None) -> tuple:
    """sha256 over o and lse, and over o, lse, dq, dk and dv, of
    ``BF16_BITS_CASES``, inputs drawn on ``dev`` from seed 26 in ``dtype``
    (bf16 unless given); ``fwd(q, k, v, causal, window)`` returns (o,
    lse), ``bwd(q, k, v, o, lse, dout, causal, window)`` (dq, dk, dv).
    Returns the two hex digests (forward, all)."""
    import hashlib
    import torch
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    h_fwd, h = hashlib.sha256(), hashlib.sha256()
    for (B, S, H, KVH, D, causal, window) in BF16_BITS_CASES:
        q = _rand(gen, (B, S, H, D), dtype, dev)
        k, v = (_rand(gen, (B, S, KVH, D), dtype, dev) for _ in range(2))
        dout = _rand(gen, (B, S, H, D), dtype, dev)
        o, lse = fwd(q, k, v, causal, window)
        for i, t in enumerate((o, lse, *bwd(q, k, v, o, lse, dout, causal,
                                            window))):
            b = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            h.update(b)
            if i < 2:
                h_fwd.update(b)
    return h_fwd.hexdigest(), h.hexdigest()


def _bf16_bits_unchanged(dev) -> str:
    """The bf16 route's bits at q_offset = 0 against ``BF16_FWD_BITS``
    (the forward's) and ``BF16_BITS`` (with the backward's)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    got_fwd, got = bf16_bits(
        dev, lambda q, k, v, c, w: flash_attention_fwd(
            q, k, v, causal=c, window=w, q_offset=0),
        lambda q, k, v, o, lse, do, c, w: flash_attention_bwd(
            q, k, v, o, lse, do, causal=c, window=w, q_offset=0))
    require(got_fwd == BF16_FWD_BITS, f"bf16 flash forward at q_offset = 0 "
            f"changed its bits: sha256 {got_fwd}, before {BF16_FWD_BITS}")
    require(got == BF16_BITS, f"bf16 flash outputs at q_offset = 0 changed "
            f"their bits: sha256 {got}, before {BF16_BITS}")
    return got


def _reference_signature(gen, dev) -> dict:
    """``flash_attention_kernel`` in the reference's signature and layout
    (q (B, H, S, D), k and v (B, KVH, S, D), causal and windowed): its
    output against ``flash_attention_ref`` on the same tensors, f32 and
    bf16 (``_flash_close``)."""
    import torch
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for causal, window in ((True, 0), (True, 37), (False, 0)):
            q = _rand(gen, (2, 8, 100, 64), dt, dev)
            k, v = (_rand(gen, (2, 2, 100, 64), dt, dev) for _ in range(2))
            o = flash_attention_kernel(q, k, v, causal=causal, window=window)
            ref = flash_attention_ref(q, k, v, causal=causal, window=window)
            name = f"{str(dt).split('.')[-1]}_causal{int(causal)}_w{window}"
            errs[name] = _flash_close(o, ref, False, f"flash_attention_"
                                      f"kernel {name}")[0]
    return errs


def _split_pairs(S: int, lo: int, hi: int, causal: bool, window: int) -> int:
    """(q, k) pairs that rows at absolute positions [lo, hi) of a sequence
    of S keys see under the mask."""
    n = 0
    for p in range(lo, hi):
        first = max(0, p - window + 1) if window > 0 else 0
        n += (p + 1 if causal else S) - first
    return n


def _split_keys(S: int, lo: int, hi: int, causal: bool, window: int) -> int:
    """Keys that rows at absolute positions [lo, hi) of a sequence of S
    keys reach under the mask: the kernels' ``k_range`` loads no other
    key tile."""
    first = max(0, lo - window + 1) if window > 0 else 0
    return max(0, (hi if causal else S) - first)


def _seq_split_case(gen, dev, name: str, B, S, H, KVH, D, dtype, causal,
                    window, m: int, iters: int) -> dict:
    """One shape of a sequence split over ``m`` ranks, emulated in one
    process as ``models.attention._flash_dist`` runs it on each rank: rank
    r calls ``flash_attention`` on its rows ``[r S/m, (r+1) S/m)`` of q at
    ``q_offset = r S/m`` over the whole K/V, forward and backward through
    autograd.  Counters are zeroed just before the ranks' calls and read
    just after: one forward and one backward launch a rank.  Then (a) each
    rank's output and gradients against the plain version at the same
    offset (``_flash_close``: bf16 rows within 2e-2 against the plain
    forward and the plain backward given the kernel's output, gradients
    within 2e-2 x max|ref| of autograd; f32 element-wise 2e-5 / 1e-4), (b)
    the ranks' outputs and dq concatenated, dk and dv summed, against the
    whole unsplit kernel call (the same bounds; bits equal or not), and
    each rank's and the whole call's device ms beside their bounds (K/V
    read over the keys the rank's mask reaches, ``_split_keys``; dk and dv
    written over all S), and the plain version's and SDPA's ms at the
    first, middle and last rank and the whole call."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    rows = S // m
    require(rows * m == S, f"seq_split {name}: {m} ranks do not divide {S}")
    kw = dict(causal=causal, window=window)
    what = (f"seq_split {name} B{B} S{S} H{H} KVH{KVH} D{D} "
            f"{str(dtype).split('.')[-1]} causal={causal} window={window} "
            f"ranks={m}")
    q = _rand(gen, (B, S, H, D), dtype, dev)
    k = _rand(gen, (B, S, KVH, D), dtype, dev).requires_grad_(True)
    v = _rand(gen, (B, S, KVH, D), dtype, dev).requires_grad_(True)
    dout = _rand(gen, (B, S, H, D), dtype, dev)
    qs = [q[:, r * rows:(r + 1) * rows].detach().requires_grad_(True)
          for r in range(m)]

    sync(dev)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    outs, grads = [], []
    for r in range(m):
        o = flash_attention(qs[r], k, v, q_offset=r * rows, **kw)
        grads.append(torch.autograd.grad(
            o, (qs[r], k, v), dout[:, r * rows:(r + 1) * rows]))
        outs.append(o.detach())
    sync(dev)
    counts = _launches()
    ranks_s = time.perf_counter() - t0
    # bf16 ranks of more than DECODE_MAX_ROWS rows: the wgmma forward
    # bf16 ranks of more than DECODE_MAX_ROWS rows: the wgmma forward; f32
    # ranks: the f32 route's forward and backward
    f32 = dtype == torch.float32
    require(dev.type != "cuda" or (
        counts["flash_attention"] == m and counts["flash_attention_bwd"] == m
        and counts["flash_wgmma_fwd"] == (0 if f32 else m)
        and counts["flash_f32_fwd"] == counts["flash_f32_bwd"]
        == (m if f32 else 0)),
            f"{what}: launches {counts}")

    # (a) each rank against the plain version at its offset
    e_fwd = e_grad = (0.0, 0.0)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    for r in range(m):
        off, qr = r * rows, qs[r]
        dr = dout[:, off:off + rows]
        ref = flash_attention_ref(qr.transpose(1, 2), kt, vt, q_offset=off,
                                  **kw).transpose(1, 2)
        e = _flash_close(outs[r], ref.detach(), False, f"{what} rank {r}")
        e_fwd = tuple(map(max, e_fwd, e))
        want = torch.autograd.grad(ref, (qr, k, v), dr)
        del ref
        if f32:
            es = [_flash_close(a, b, True, f"{what} rank {r} d{n}")
                  for a, b, n in zip(grads[r], want, "qkv")]
        else:
            with torch.no_grad():
                plain = [x.transpose(1, 2) for x in flash_attention_bwd_ref(
                    qr.transpose(1, 2), kt, vt, outs[r].transpose(1, 2),
                    dr.transpose(1, 2), q_offset=off, **kw)]
            es = [(_close_max(a, b, f"{what} rank {r} d{n}"),
                   _flash_close(a, c, True, f"{what} rank {r} d{n}, plain "
                                "backward")[1])
                  for a, b, c, n in zip(grads[r], want, plain, "qkv")]
            del plain
        del want
        e_grad = tuple(max(x, *(y[i] for y in es))
                       for i, x in enumerate(e_grad))

    # (b) the ranks together against the whole unsplit call
    with torch.no_grad():
        o_w, lse_w = flash_attention_fwd(q, k, v, **kw)
        dq_w, dk_w, dv_w = flash_attention_bwd(q, k, v, o_w, lse_w, dout,
                                               **kw)
        joined = {
            "o": (torch.cat(outs, dim=1), o_w),
            "dq": (torch.cat([g[0] for g in grads], dim=1), dq_w),
            "dk": (sum(g[1].float() for g in grads).to(dtype), dk_w),
            "dv": (sum(g[2].float() for g in grads).to(dtype), dv_w)}
    sync(dev)
    e_whole, same = (0.0, 0.0), {}
    for n, (a, b) in joined.items():
        e = _flash_close(a, b, n != "o", f"{what}: ranks joined {n} against "
                         "the whole call")
        e_whole = tuple(map(max, e_whole, e))
        same[n] = bool(torch.equal(a, b))
    del joined, grads

    # device ms: each rank's forward and backward, and the whole call's;
    # the plain version's and SDPA's (one call over the rank's Sq x Sk
    # offset mask) at the first, middle and last rank and the whole call
    el = q.element_size()

    def bound(lo, hi, bwd):
        n = hi - lo
        pairs = _split_pairs(S, lo, hi, causal, window)
        flops = (10 if bwd else 4) * B * H * D * pairs
        # read once / written once: q, o (, dout, dq) over the rows, k, v
        # over the keys the rows reach (, dk, dv written over all S: a key
        # no row sees gets a zero), lse (B, H, rows) f32
        keys = _split_keys(S, lo, hi, causal, window)
        nbytes = el * B * ((4 if bwd else 2) * n * H * D + 2 * keys * KVH * D
                           + (2 * S * KVH * D if bwd else 0)) + 4 * B * H * n
        return {**_bound(flops, nbytes, dtype), "keys": keys}

    def timed(off, qr, dr, o_r, lse_r, others: bool) -> dict:
        n = qr.shape[1]
        with torch.no_grad():
            out = {"fwd_ms": time_ms(dev, [lambda: flash_attention_fwd(
                qr, k, v, q_offset=off, **kw)], iters),
                "bwd_ms": time_ms(dev, [lambda: flash_attention_bwd(
                    qr, k, v, o_r, lse_r, dr, q_offset=off, **kw)], iters)}
        if not others:
            return out
        qt, dt = qr.transpose(1, 2), dr.transpose(1, 2)
        pos = off + torch.arange(n, device=dev)[:, None]
        key = torch.arange(S, device=dev)[None, :]
        mask = (pos >= key) if causal else torch.ones_like(pos >= key)
        if window > 0:
            mask &= (pos - key) < window
        for label, fn in (
                ("plain", lambda: flash_attention_ref(
                    qt, kt, vt, q_offset=off, **kw)),
                ("library", lambda: torch.nn.functional
                 .scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True))):
            with torch.no_grad():
                out[f"{label}_fwd_ms"] = time_ms(dev, [fn], iters)
            y = fn()
            out[f"{label}_bwd_ms"] = time_ms(dev, [
                lambda: torch.autograd.grad(y, (qr, k, v), dt,
                                            retain_graph=True)], iters)
            del y
        del mask
        return out

    others = {0, m // 2, m - 1}
    per_rank = []
    for r, qr in enumerate(qs):
        off = r * rows
        dr = dout[:, off:off + rows]
        with torch.no_grad():
            o_r, lse_r = flash_attention_fwd(qr, k, v, q_offset=off, **kw)
        per_rank.append({"rank": r, "q_offset": off,
                         **timed(off, qr, dr, o_r, lse_r, r in others),
                         "fwd": bound(off, off + rows, False),
                         "bwd": bound(off, off + rows, True)})
        del o_r, lse_r
    q.requires_grad_(True)
    whole = {**timed(0, q, dout, o_w, lse_w, True),
             "fwd": bound(0, S, False), "bwd": bound(0, S, True)}
    del q, k, v, dout, qs, outs, o_w, lse_w, dq_w, dk_w, dv_w, kt, vt
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"shape": {"B": B, "S": S, "H": H, "KVH": KVH, "D": D,
                      "dtype": str(dtype).split(".")[-1], "causal": causal,
                      "window": window, "ranks": m, "rows_per_rank": rows},
            "launches": {n: counts[n] for n in SEQ_SPLIT_COUNTERS},
            "ranks_seconds": ranks_s,
            "max_abs_err": {"rank_fwd": e_fwd[0], "rank_fwd_row_rel": e_fwd[1],
                            "rank_grad": e_grad[0],
                            "rank_grad_row_rel": e_grad[1],
                            "joined_vs_whole": e_whole[0],
                            "joined_vs_whole_row_rel": e_whole[1]},
            "bit_identical_to_whole": same,
            "whole": whole,
            "ranks_fwd_ms_sum": sum(p["fwd_ms"] for p in per_rank),
            "ranks_bwd_ms_sum": sum(p["bwd_ms"] for p in per_rank),
            "per_rank": per_rank}


def phase_seq_split(dev, sz: Sizes, table) -> dict:
    """The flash phase's ``seq_split`` case at four shapes: Qwen3-14B's
    training shape (bf16, causal), Mixtral-8x7B's heads at S = 8,192 with
    its 4,096-token window active (bf16), StarCoder2-3B's heads in f32 at
    S = 1,536 (96 rows a rank: an offset that is no multiple of the f32
    kernels' 64-row tiles) and H2O-Danube-1.8B's head_dim 80 (bf16,
    causal); ``sz.seq_split_ranks`` ranks each.  Emits the cases whole,
    credits the ranks' launches to the flash rows of ``table`` (path
    ``seq_split``) and adds each shape's per-rank device ms and bounds,
    and the plain version's and SDPA's ms at three ranks and the whole
    call, to them."""
    import torch
    from repro_torch.configs import get_config
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    m, it = sz.seq_split_ranks, sz.seq_split_iters
    cases = {}
    total = dict.fromkeys(SEQ_SPLIT_COUNTERS, 0)
    for name, arch, S, dtype, window in (
            ("qwen3_train", sz.arch, sz.train_seq, torch.bfloat16, 0),
            ("mixtral_window", sz.moe_arch, 2 * sz.train_seq,
             torch.bfloat16, None),
            ("starcoder2_f32", "starcoder2_3b", sz.seq_split_f32_seq,
             torch.float32, 0),
            ("danube_d80", sz.danube_arch, sz.train_seq, torch.bfloat16, 0)):
        c = get_config(arch)
        w = c.sliding_window if window is None else window
        case = _seq_split_case(gen, dev, name, 1, S, c.n_heads, c.n_kv_heads,
                               c.head_dim, dtype, True, w, m, it)
        case["arch"] = c.name
        for n in total:
            total[n] += case["launches"][n]
        cases[name] = case
    emit("seq_split", cases=cases, launches=total,
         library="F.scaled_dot_product_attention over the rank's Sq x Sk "
         "offset mask (enable_gqa), its backward by autograd",
         tolerance={"float32": {"forward": TOL["float32"],
                                "gradients": GRAD_TOL_F32},
                    "bfloat16": "2e-2 relative L2 error per row against "
                    "the plain forward and the plain backward given the "
                    "kernel's output; gradients also within 2e-2 x max|ref| "
                    "of autograd"})
    _add_launches(table, "seq_split", total, tuple(total))
    for row in table:
        kind = {"flash_attention": "fwd",
                "flash_attention_bwd": "bwd"}.get(row["name"])
        if kind:
            row["seq_split"] = {name: {
                "shape": c["shape"],
                "rank_ms": [p[f"{kind}_ms"] for p in c["per_rank"]],
                "rank_bound_ms": [p[kind]["bound_ms"] for p in c["per_rank"]],
                "rank_bound_by": [p[kind]["bound_by"] for p in c["per_rank"]],
                "rank_plain_ms": {p["rank"]: p[f"plain_{kind}_ms"]
                                  for p in c["per_rank"]
                                  if f"plain_{kind}_ms" in p},
                "rank_library_ms": {p["rank"]: p[f"library_{kind}_ms"]
                                    for p in c["per_rank"]
                                    if f"library_{kind}_ms" in p},
                "whole_ms": c["whole"][f"{kind}_ms"],
                "whole_bound_ms": c["whole"][kind]["bound_ms"],
                "whole_plain_ms": c["whole"][f"plain_{kind}_ms"],
                "whole_library_ms": c["whole"][f"library_{kind}_ms"],
                "bit_identical_to_whole": c["bit_identical_to_whole"],
                "max_abs_err": c["max_abs_err"]} for name, c in cases.items()}
    return cases


def phase_flash(dev, sz: Sizes, cfg, names: list):
    """Flash attention: the cases above in f32 and bf16, then the training
    shape (B=1, S=4096, H=40, KVH=8, D=128, causal) in f32 and in bf16,
    then DeepSeek-V3's (H=KVH=128, D=192: nope 128 + rope 64) and
    Zamba2-7B's (H=KVH=32, D=112) in bf16 at the training shape's S and in
    f32 at a shorter one; then cross-attention (Sq != Sk, non-causal: the
    cases of ``CROSS_CASES`` in both dtypes, the refused masks) and
    Whisper-medium's three shapes in bf16: the decode call (Sq = 1 over
    the 1,500 frames, B = 4 and 1; forward only, the decode kernel of
    ``csrc/flash_decode.cu`` beside the tile kernel it replaces there),
    the training cross shape and the encoder's (S = 1,500, non-causal):
    errors against the plain version, kernel / plain / SDPA times, FLOP
    bounds; the decode kernel at masked few-row shapes with a query offset
    (``DECODE_CASES``, every cluster size, lse too, two calls
    bit-identical) and its forward followed by the backward kernels
    (``DECODE_GRAD_CASES``); the bf16 forward of
    ``csrc/flash_attention_wgmma.cu`` and backward of
    ``csrc/flash_attention_wgmma_bwd.cu`` at their edges
    (``WGMMA_CASES``, ``WGMMA_REPEAT``, ``_bwd_views``); the f32 route at
    the training shape and the training example's call, timed beside SDPA;
    and
    ``flash_attention_kernel`` in the reference's signature."""
    import torch
    from repro_torch.configs import get_config

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    keys = ("fwd_abs", "fwd_row_rel", "grad_abs", "grad_row_rel")
    errs = {"float32": dict.fromkeys(keys, 0.0),
            "bfloat16": dict.fromkeys(keys, 0.0)}
    for case in FLASH_CASES:
        for dt in (torch.float32, torch.bfloat16):
            e = _flash_case(gen, dev, *case[:5], dt, *case[5:])
            n = str(dt).split(".")[-1]
            errs[n] = {k: max(errs[n][k], x)
                       for k, x in zip(keys, e[0] + e[1])}

    # the f32 route's own edges
    f32_edges = _f32_edges(gen, dev)
    errs["float32_route_edges"] = f32_edges["max_abs_err"]

    # the training shape: one layer of one microbatch of the train phase;
    # in f32 (the f32 route) also the training example's call (its
    # batch of 8 in two microbatches, 8 / 4 heads of 64 over 64 tokens)
    B, S, H, KVH, D = 1, sz.train_seq, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    it = sz.flash_iters
    f32_train = _flash_f32_shape(gen, dev, "training shape", B, S, H, KVH, D,
                                 it)
    errs["float32_training_shape"] = dict(zip(keys, f32_train["errs"]))
    names += [f"{n}_f32_training" for n in FLASH_TIMED_F32]
    f32_example = _flash_f32_shape(gen, dev, "training example", *EXAMPLE_F32,
                                   it)
    errs["float32_training_example"] = dict(zip(keys, f32_example["errs"]))
    names += [f"{n}_f32_example" for n in FLASH_TIMED_F32]
    sync(dev)
    torch.cuda.empty_cache()
    main = _flash_bf16_shape(gen, dev, B, S, H, KVH, D, it)
    errs["bfloat16_training_shape"] = dict(zip(keys, main["errs"]))
    names += list(FLASH_TIMED)

    # DeepSeek-V3's MLA at head_dim 192, the train_mla shape's one layer
    mcfg = get_config(sz.mla_arch)
    D2 = mcfg.qk_nope_head_dim + mcfg.qk_rope_head_dim
    H2 = mcfg.n_heads
    e = _flash_case(gen, dev, 1, sz.mla_parity_seq // 2, H2, H2, D2,
                    torch.float32, True, 0)
    errs["float32_head_dim_192"] = dict(zip(keys, e[0] + e[1]))
    wide = _flash_bf16_shape(gen, dev, 1, S, H2, H2, D2, it)
    errs["bfloat16_head_dim_192"] = dict(zip(keys, wide["errs"]))
    names += [f"{n}_d{D2}" for n in FLASH_TIMED]

    # Zamba2-7B's shared attention at head_dim 112, the train_hybrid
    # shape's one application (H = KVH = 32)
    zcfg = get_config(sz.zamba_arch)
    H3, KVH3, D3 = zcfg.n_heads, zcfg.n_kv_heads, zcfg.head_dim
    e = _flash_case(gen, dev, 1, sz.hybrid_parity_seq // 2, H3, KVH3, D3,
                    torch.float32, True, 0)
    errs[f"float32_head_dim_{D3}"] = dict(zip(keys, e[0] + e[1]))
    z = _flash_bf16_shape(gen, dev, 1, S, H3, KVH3, D3, it)
    errs[f"bfloat16_head_dim_{D3}"] = dict(zip(keys, z["errs"]))
    names += [f"{n}_d{D3}" for n in FLASH_TIMED]

    # cross-attention, Sq != Sk (Whisper-medium's decoder over its frames)
    cross_errs = {"float32": dict.fromkeys(keys, 0.0),
                  "bfloat16": dict.fromkeys(keys, 0.0)}
    for (B4, Sq, Sk, H4, KVH4, D4, fused) in CROSS_CASES:
        for dt in (torch.float32, torch.bfloat16):
            e = _flash_case(gen, dev, B4, Sq, H4, KVH4, D4, dt, False, 0,
                            fused=fused, Sk=Sk)
            n = str(dt).split(".")[-1]
            cross_errs[n] = {k: max(cross_errs[n][k], x)
                             for k, x in zip(keys, e[0] + e[1])}
    errs["cross_attention"] = cross_errs
    errs["reference_signature"] = _reference_signature(gen, dev)
    wgmma = _wgmma_checks(gen, dev)
    errs["bfloat16_wgmma_forward"] = wgmma["max_abs_err"]
    bits = _bf16_bits_unchanged(dev)
    refused = _cross_refused(gen, dev)
    wcfg = get_config(sz.whisper_arch)
    Hw, Dw, T = wcfg.n_heads, wcfg.head_dim, wcfg.max_source_positions
    sync(dev)
    torch.cuda.empty_cache()
    w_dec = _flash_bf16_shape(gen, dev, sz.max_batch, 1, Hw, Hw, Dw, it,
                              Sk=T, causal=False, backward=False)
    names += [f"{n}_whisper_decode" for n in FLASH_TIMED_FWD]
    w_dec1 = _flash_bf16_shape(gen, dev, 1, 1, Hw, Hw, Dw, it, Sk=T,
                               causal=False, backward=False)
    names += [f"{n}_whisper_decode_batch1" for n in FLASH_TIMED_FWD]
    # the decode kernel at masked few-row shapes with a query offset, and
    # its forward followed by the backward kernels
    dec_errs = {}
    for case in DECODE_CASES:
        for dt in (torch.bfloat16, torch.float32):
            e = _decode_check(gen, dev, *case[:6], dt, *case[6:])
            n = str(dt).split(".")[-1]
            dec_errs[n] = {k: max(dec_errs.get(n, {}).get(k, 0.0), x)
                           for k, x in e.items()}
    for case in DECODE_GRAD_CASES:
        B5, Sq5, Sk5, H5, KVH5, D5, c5, w5, off5 = case
        for dt in (torch.float32, torch.bfloat16):
            e = _flash_case(gen, dev, B5, Sq5, H5, KVH5, D5, dt, c5, w5,
                            Sk=Sk5, q_offset=off5)
            n = f"{str(dt).split('.')[-1]}_decode_forward_then_backward"
            dec_errs[n] = {k: max(dec_errs.get(n, {}).get(k, 0.0), x)
                           for k, x in zip(keys, e[0] + e[1])}
    errs["flash_decode"] = dec_errs
    w_cross = _flash_bf16_shape(gen, dev, sz.whisper_train_batch,
                                wcfg.max_target_positions, Hw, Hw, Dw, it,
                                Sk=T, causal=False)
    names += [f"{n}_whisper_cross" for n in FLASH_TIMED]
    w_enc = _flash_bf16_shape(gen, dev, sz.whisper_train_batch, T, Hw, Hw,
                              Dw, it, causal=False)
    names += [f"{n}_whisper_encoder" for n in FLASH_TIMED]
    errs["bfloat16_whisper_shapes"] = {
        "decode": dict(zip(keys[:2], w_dec["errs"])),
        "decode_batch1": dict(zip(keys[:2], w_dec1["errs"])),
        "cross": dict(zip(keys, w_cross["errs"])),
        "encoder": dict(zip(keys, w_enc["errs"]))}
    whisper = {"arch": wcfg.name, "decode_shape": w_dec["shape"],
               "cross_shape": w_cross["shape"],
               "encoder_shape": w_enc["shape"],
               "cross_cases_checked": 2 * len(CROSS_CASES),
               "masked_sq_ne_sk_refused": refused}

    src = "src/repro_torch/kernels/csrc/flash_attention_wgmma_bwd.cu"
    fwd_src = "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"
    design = {
        "instruction": "wgmma.mma_async m64nNk16 bf16 x bf16 -> f32: S, dP "
        "(dQ) and S^T, dP^T (dK/dV) from shared memory, both operands "
        "K-major; dQ += dS K, dV += P^T dO, dK += dS^T Q with the A operand "
        "in registers and B MN-major in shared memory",
        "loads": "cp.async.bulk.tensor over 4-d tensor maps of q, k, v, o "
        "and dout (128-byte swizzle) and 1-d maps of lse and delta; dQ: Q, "
        "dO, O once, K and V through a ring of 4 stages (2 at D 192); "
        "dK/dV: K and V once, Q, dO, lse, delta through a ring of 4 stages "
        "(2 at D 192), full / empty mbarriers",
        "threads": "two consumer warpgroups of 64 rows (dQ: query rows, "
        "dK/dV: keys) and a producer warpgroup (one issuing thread); "
        "setmaxnreg 24 / 240",
        "schedule": "dQ: tile j's S and dP issued before tile j-1's dQ "
        "product, its dS formed under it; the two warpgroups take turns to "
        "issue S and dP (ping-pong); dQ walks (batch, head) pairs in groups "
        "whose K/V fit 32 MB of L2, latest q tiles first, dK/dV (batch, kv "
        "head) pairs in groups whose Q/dO fit, earliest k tiles first",
        "split": "dQ and dK/dV in separate kernels (S and dP computed in "
        "both), no atomics: two calls give identical bits",
        "instances": "D 64, 128, 192 (16-48 on 64, 80-112 on 128); dQ 64 "
        "keys a tile, dK/dV 64 query rows a tile; dK/dV at 192 in two "
        "passes"}
    fwd_design = {
        "instruction": "wgmma.mma_async m64nNk16 bf16 x bf16 -> f32: S = Q "
        "K^T from shared memory (K-major), O += P V with P in registers and "
        "V MN-major in shared memory", "loads": "cp.async.bulk.tensor over "
        "three 4-d tensor maps (128-byte swizzle), Q once, K and V through "
        "a ring of 3 stages (4 at D 64) under full / empty mbarriers",
        "threads": "two consumer warpgroups of 64 query rows and a producer "
        "warpgroup (one issuing thread); setmaxnreg 24 / 240",
        "schedule": "tile j's QK^T issued before tile j-1's PV, its "
        "softmax under both; the two warpgroups take turns to issue "
        "(ping-pong); (batch, head) pairs in groups whose K/V fit 32 MB of "
        "L2, latest q tiles first",
        "instances": "D 64, 128, 192 (16-48 on 64, 80-112 on 128); 128, 112 "
        "and 64 keys a tile"}
    tpu = "src/repro/kernels/flash_attention/flash_attention.py:79"
    d192 = {"arch": mcfg.name, "shape": wide["shape"],
            "design": "forward 64-key tiles; backward dQ 64-key tiles, dK "
            "and dV in two passes of 64-row q tiles (no spills)"}
    d112 = {"arch": zcfg.name, "shape": z["shape"]}
    f, b = main["fwd"], main["bwd"]
    dec = w_dec["fwd"]
    f32_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    f32f, f32b = f32_train["fwd"], f32_train["bwd"]
    f32_design = {
        "instruction": "wgmma.mma_async m64nNk8 tf32 x tf32 -> f32, three "
        "products a product (3xTF32: each operand split into a TF32 big "
        "part, its low 13 bits cleared, and the rest; a_big b_big + a_big "
        "b_small + a_small b_big), B K-major in shared memory, A there too "
        "where a block splits it once (the forward's Q at D 64, dQ's Q and "
        "dO at D <= 128), else in registers (split a k step ahead, or from "
        "the accumulator); V, K, dO and Q written transposed by the "
        "consumers where the reduction runs down the rows",
        "loads": "cp.async.bulk.tensor over 4-d tensor maps "
        "of q, k, v, o and dout (f32, 32-column boxes, 128-byte swizzle) "
        "and 1-d maps of lse and delta; a ring under full / empty "
        "mbarriers", "threads": "one consumer warpgroup of 64 rows and a "
        "producer warp (one issuing thread)", "instances": "D 64, 128, 192 "
        "(16-48 on 64, 80-112 on 128); keys a tile forward 64 / 64 / 32, "
        "dQ 64 / 32 / 32; dK/dV query rows 64 / 32 / 32, one query head a "
        "block, G > 1 summed in head order by flash_bwd_dkdv_sum_kernel; "
        "dK/dV at 192 in two passes"}
    rows = [
        {"name": "flash_attention", "route": "cuda", "source": fwd_src,
         "replaces": tpu, "launches": 0, "max_abs_err": f["max_abs_err"],
         "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
         "bound_by": f["bound_by"], "library_ms": f["library_ms"],
         "library": "F.scaled_dot_product_attention (enable_gqa)",
         **fwd_design, "flops": f["flops"], "bytes": f["bytes"],
         "tflops_per_s": f["tflops_per_s"], "shape": main["shape"],
         "head_dim_192": {**d192, **wide["fwd"]},
         f"head_dim_{D3}": {**d112, **z["fwd"]},
         "bf16_q_offset0_sha256_unchanged": bits,
         "whisper": {**whisper, "decode": w_dec["fwd"],
                     "decode_batch1": w_dec1["fwd"],
                     "cross": w_cross["fwd"], "encoder": w_enc["fwd"]},
         "note": "launches count every forward, the decode kernel's, the "
         "bf16 wgmma kernel's and the f32 route's too (their own rows "
         "below)"},
        {"name": "flash_wgmma_fwd", "route": "cuda", "source": fwd_src,
         "replaces": tpu, "note": "the bf16 forward of calls of more than "
         "DECODE_MAX_ROWS query rows (forward_entry); each launch also "
         "counts under flash_attention", "launches": 0,
         "max_abs_err": max(f["max_abs_err"],
                            wgmma["max_abs_err"]["fwd_abs"]),
         "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
         "bound_by": f["bound_by"], "library_ms": f["library_ms"],
         "library": "F.scaled_dot_product_attention (enable_gqa)",
         **fwd_design, "shape": main["shape"],
         "tflops_per_s": f["tflops_per_s"],
         "head_dim_192": {"arch": mcfg.name, "shape": wide["shape"],
                          **wide["fwd"]},
         f"head_dim_{D3}": {**d112, **z["fwd"]},
         "whisper": {"cross": {"shape": w_cross["shape"], **w_cross["fwd"]},
                     "encoder": {"shape": w_enc["shape"], **w_enc["fwd"]}},
         "checks": wgmma},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": tpu, "note": "the forward of calls of at most "
         "DECODE_MAX_ROWS query rows, in bf16 and f32 (forward_entry); "
         "each launch also counts under flash_attention",
         "launches": 0, "max_abs_err": dec["max_abs_err"], "ms": dec["ms"],
         "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
         "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
         "library": "F.scaled_dot_product_attention",
         "tile_kernel_ms": dec["tile_kernel_ms"],
         "n_splits": dec["n_splits"], "shape": w_dec["shape"],
         "batch1": {"shape": w_dec1["shape"], **w_dec1["fwd"]},
         "lse_err": dec["lse_err"],
         "bit_identical_over_two_calls": dec[
             "bit_identical_over_two_calls"],
         "design": "split-KV over a thread-block cluster (DSMEM combine in "
         "rank order), one producer lane's cp.async.bulk.tensor copies of "
         "whole stages through 2-D tensor maps of k and v in the model "
         "layout into an mbarrier ring, consumer warps split the keys, "
         "every query row of a KV head in one block, f32 on the CUDA cores",
         "masked_cases_checked": len(DECODE_CASES) * 2 * 5,
         "max_abs_err_masked": dec_errs},
        {"name": "flash_attention_bwd", "route": "cuda", "source": src,
         "replaces": tpu, "note": "the TPU kernel has no backward: the "
         "reference differentiates src/repro/models/attention_ops.py:77 "
         "flash_attention_xla with XLA", "launches": 0,
         "max_abs_err": b["max_abs_err"], "ms": b["ms"],
         "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
         "bound_by": b["bound_by"], "library_ms": b["library_ms"],
         "library": "autograd of F.scaled_dot_product_attention",
         "library_fwd_bwd_ms": b["library_fwd_bwd_ms"], **design,
         "checks": {
             "edge_cases": wgmma["cases"],
             "edge_max_err": {k: wgmma["max_abs_err"][k]
                              for k in ("grad_abs", "grad_row_rel")},
             "bit_identical_over_two_calls": wgmma[
                 "backward_bit_identical_over_two_calls"],
             "reference_signature_views": wgmma[
                 "backward_reference_signature_views"]},
         "flops": b["flops"], "bytes": b["bytes"],
         "tflops_per_s": b["tflops_per_s"], "shape": main["shape"],
         "head_dim_192": {**d192, **wide["bwd"]},
         f"head_dim_{D3}": {**d112, **z["bwd"]},
         "whisper": {**whisper, "cross": w_cross["bwd"],
                     "encoder": w_enc["bwd"]},
         "note": "launches count every backward, the f32 route's too (its "
         "own row below)"},
        {"name": "flash_f32_fwd", "route": "cuda", "source": f32_src,
         "replaces": tpu, "note": "the f32 forward of calls of more than "
         "DECODE_MAX_ROWS query rows (forward_entry); each launch also "
         "counts under flash_attention", "launches": 0,
         "max_abs_err": max(f32f["max_abs_err"],
                            f32_example["fwd"]["max_abs_err"],
                            f32_edges["max_abs_err"]["fwd_abs"]),
         "ms": f32f["ms"], "plain_ms": f32f["plain_ms"],
         "bound_ms": f32f["bound_ms"], "bound_by": f32f["bound_by"],
         "bound_cuda_cores_ms": f32f["bound_cuda_cores_ms"],
         "library_ms": f32f["library_ms"],
         "library": "F.scaled_dot_product_attention (enable_gqa)",
         **f32_design, "flops": f32f["flops"], "bytes": f32f["bytes"],
         "shape": f32_train["shape"],
         "training_example": {"shape": f32_example["shape"],
                              **f32_example["fwd"]},
         "edges": f32_edges},
        {"name": "flash_f32_bwd", "route": "cuda", "source": f32_src,
         "replaces": tpu, "note": "the gradient of the f32 route; each "
         "launch (dQ, dK/dV, and for G > 1 the group sum) counts once here "
         "and once under flash_attention_bwd", "launches": 0,
         "max_abs_err": max(f32b["max_abs_err"],
                            f32_example["bwd"]["max_abs_err"],
                            f32_edges["max_abs_err"]["grad_abs"]),
         "ms": f32b["ms"], "plain_ms": f32b["plain_ms"],
         "bound_ms": f32b["bound_ms"], "bound_by": f32b["bound_by"],
         "bound_cuda_cores_ms": f32b["bound_cuda_cores_ms"],
         "library_ms": f32b["library_ms"],
         "library": "autograd of F.scaled_dot_product_attention",
         **f32_design, "flops": f32b["flops"], "bytes": f32b["bytes"],
         "shape": f32_train["shape"],
         "bit_identical_over_two_calls": f32_train[
             "backward_bit_identical_over_two_calls"],
         "training_example": {
             "shape": f32_example["shape"], **f32_example["bwd"],
             "bit_identical_over_two_calls": f32_example[
                 "backward_bit_identical_over_two_calls"]},
         "edges": f32_edges},
    ]
    cases = 2 * len(FLASH_CASES) + 8 + 2 * len(CROSS_CASES) + refused + 4 \
        + 2 * len(F32_EDGE_CASES) \
        + len(errs["reference_signature"]) + 10 * len(DECODE_CASES) \
        + 2 * len(DECODE_GRAD_CASES) + wgmma["cases"] \
        + wgmma["bit_identical_over_two_calls"] \
        + wgmma["backward_bit_identical_over_two_calls"] + 1
    return rows, errs, cases


def _long_row_check(q, kp, vp, pt, ln) -> dict:
    """The bf16 long-context case held row by row: each output row (one
    head; ~0.009 in size, the mean of ~12k random V rows) within
    ``TOL['bfloat16']`` relative L2 error of its reference row, at every
    cluster size.  The limit is shown to reject an output that misses one
    split's tokens or a single 64-row tile (the reference at the length
    less an eighth, or less 64)."""
    import torch
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention_kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    ref = paged_attention_ref(q, kp, vp, pt, ln)
    rel = 0.0
    for n in SPLITS:
        out = paged_attention_kernel(q, kp, vp, pt, ln, n_splits=n)
        r = _row_rel_err(out, ref)
        require(r <= TOL["bfloat16"], f"paged_attention long context "
                f"bfloat16 n_splits={n}: a row's relative L2 error {r} "
                f"beyond {TOL['bfloat16']}")
        rel = max(rel, r)
    length = int(ln[0])
    faults = {}
    for what, drop in (("one_split_dropped", length // 8),
                       ("one_tile_dropped", 64)):
        short = torch.tensor([length - drop], dtype=ln.dtype,
                             device=ln.device)
        faults[what] = _row_rel_err(
            paged_attention_ref(q, kp, vp, pt, short), ref)
    require(min(faults.values()) > TOL["bfloat16"],
            f"paged_attention long context: the row check does not reject "
            f"an output missing one split or one tile ({faults})")
    return {"row_rel_err": rel, "row_rel_limit": TOL["bfloat16"],
            "row_rel_err_of_faulted_outputs": faults}


def _long_context(gen, dev, sz: Sizes, H, KVH, D, ps) -> dict:
    """B=1 at the model's native context (``long_pages`` pages, full): the
    kernel against the plain version at every cluster size in bf16 and in
    f32 (bf16 also row by row, :func:`_long_row_check`), two calls
    bit-identical, then device time over ``timing_layers`` L2-cold layers
    against its bound."""
    import torch
    from repro_torch.kernels.paged_attention import \
        paged_attention as pa_kernel
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    NP = sz.long_pages
    length = NP * ps
    pt = torch.arange(NP, dtype=torch.int32, device=dev).reshape(1, NP)
    ln = torch.tensor([length], dtype=torch.int32, device=dev)
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        q = _rand(gen, (1, H, D), dt, dev)
        kp = _rand(gen, (NP, ps, KVH, D), dt, dev)
        vp = _rand(gen, (NP, ps, KVH, D), dt, dev)
        name = str(dt).split(".")[-1]
        errs[name] = _attn_splits(f"paged_attention long context {name}", q,
                                  kp, vp, pt, ln)
        if dt == torch.bfloat16:
            rows = _long_row_check(q, kp, vp, pt, ln)
        require(torch.equal(paged_attention(q, kp, vp, pt, ln),
                            paged_attention(q, kp, vp, pt, ln)),
                f"paged_attention: two calls differ (long context {name})")
        del kp, vp
    sync(dev)
    torch.cuda.empty_cache()
    Lt = sz.timing_layers
    bf16 = torch.bfloat16
    kpool = _rand(gen, (Lt, NP, ps, KVH, D), bf16, dev)
    vpool = _rand(gen, (Lt, NP, ps, KVH, D), bf16, dev)
    q = _rand(gen, (1, H, D), bf16, dev)
    ms = time_ms(dev, [lambda l=l: paged_attention(
        q, kpool[l], vpool[l], pt, ln) for l in range(Lt)], sz.timing_iters)
    plain_ms = time_ms(dev, [lambda l=l: paged_attention_ref(
        q, kpool[l], vpool[l], pt, ln) for l in range(Lt)], 4)
    del kpool, vpool
    nbytes = (2 * length * KVH * D + 2 * H * D) * 2 + NP * 4 + 4
    t_ops = 4 * length * H * D / PEAK_FLOPS["bfloat16"]
    bound_ms = max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= t_ops
            else "operations", "bound_share": bound_ms / ms, "bytes": nbytes,
            "n_splits": pa_kernel.plan_splits(dev.index or 0, 1, KVH,
                                              H // KVH, D, NP, ps, bf16),
            "shape": {"B": 1, "H": H, "KVH": KVH, "D": D, "ps": ps, "NP": NP,
                      "lengths": [length], "dtype": "bfloat16"},
            "bfloat16_rows": rows, "max_abs_err_by_dtype": errs}


def _slot_rows(L: int, P: int, per_seq: int, slot: int, dev):
    """The engine's rows of batch slot ``slot`` in a pool viewed as
    (L·P, E) (``ServingEngine._rows``)."""
    import torch
    return (torch.arange(L, dtype=torch.int32)[:, None] * P + slot * per_seq
            + torch.arange(per_seq, dtype=torch.int32)[None, :]) \
        .reshape(-1).to(dev)


def _latent_copies(gen, dev, sz: Sizes, iters: int) -> dict:
    """Page gather / scatter at the rows of DeepSeek-V3's two latent pools
    (``serve_mla_moe``): one sequence's pages of every layer <-> its batch
    slot, rows of 256 x 512 (``ckv_pool``, 256 KB) and 256 x 64
    (``krope_pool``, 32 KB) bf16.  Each against ``page_pack/ref.py`` bit
    for bit, then device times against the bytes bound, cycling through
    enough copies of the pool (16 and 2 MB) to exceed twice the L2, as a
    decode step that has streamed its weights since leaves it cold."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.page_pack.ops import gather_pages, scatter_pages
    from repro_torch.kernels.page_pack.ref import (page_gather_ref,
                                                   page_scatter_ref)
    mcfg = get_config(sz.mla_arch)
    L, P = sz.mla_layers, sz.max_batch * sz.pages_per_seq
    out = {}
    for name, width in (("ckv_pool", mcfg.kv_lora_rank),
                        ("krope_pool", mcfg.qk_rope_head_dim)):
        E = mcfg.kv_page_tokens * width
        n_pools = -(-2 * L2_BYTES // (L * P * E * 2))
        pools = [_rand(gen, (L * P, E), torch.bfloat16, dev)
                 for _ in range(n_pools)]
        pool = pools[0]
        idx = _slot_rows(L, P, sz.pages_per_seq, min(1, sz.max_batch - 1),
                         dev)
        n = idx.numel()
        blocks = [_rand(gen, (n, E), torch.bfloat16, dev)
                  for _ in range(n_pools)]
        got = gather_pages(pool, idx)
        sync(dev)
        require(torch.equal(got, page_gather_ref(pool, idx)),
                f"page_gather {name} rows")
        want = page_scatter_ref(pool.clone(), idx, blocks[0])
        res = scatter_pages(pool.clone(), idx, blocks[0])
        sync(dev)
        require(torch.equal(res, want), f"page_scatter {name} rows")
        pairs = list(zip(pools, blocks))
        il = idx.long()
        g_ms = time_ms(dev, [lambda p=p, b=b: gather_pages(p, idx, out=b)
                             for p, b in pairs], iters)
        s_ms = time_ms(dev, [lambda p=p, b=b: scatter_pages(p, idx, b)
                             for p, b in pairs], iters)
        g_plain = time_ms(dev, [lambda p=p, b=b: page_gather_ref(p, idx, b)
                                for p, b in pairs], iters)
        s_plain = time_ms(dev, [lambda p=p, b=b: page_scatter_ref(p, idx, b)
                                for p, b in pairs], iters)
        g_lib = time_ms(dev, [lambda p=p, b=b: torch.index_select(
            p, 0, il, out=b) for p, b in pairs], iters)
        s_lib = time_ms(dev, [lambda p=p, b=b: p.index_copy_(0, il, b)
                              for p, b in pairs], iters)
        floor = _copy_floor_ms(dev, n, E * 2, iters)
        del pools, blocks, pairs
        nbytes = 2 * n * E * 2 + n * 4
        out[name] = {"row_bytes": E * 2, "rows": n, "pool_rows": L * P,
                     "pools_cycled": n_pools,
                     "bytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "gather_ms": g_ms, "scatter_ms": s_ms,
                     "gather_plain_ms": g_plain, "scatter_plain_ms": s_plain,
                     "gather_library_ms": g_lib, "scatter_library_ms": s_lib,
                     "empty_kernel_ms": floor,
                     "plan": _copy_plan_of(dev, n, E * 2),
                     "gather_exact": True, "scatter_exact": True}
    return out


def _copy_plan_of(dev, n: int, row_bytes: int) -> dict:
    from repro_torch.kernels.page_pack import page_pack as pk
    mode, piece, blocks, stages = _copy_plan(dev, n, row_bytes)
    if mode == pk.WORDS:
        return {"mode": "words", "blocks": _copy_blocks(dev, n, row_bytes)}
    return {"mode": "bulk", "piece_bytes": piece, "blocks": blocks,
            "stages": stages}


def _timed_attn(gen, dev, sz: Sizes, H, KVH, D, ps, NP, lengths, window=0,
                library=False):
    """bf16 device ms of ``paged_attention`` over ``timing_layers`` L2-cold
    pools of B = len(lengths) sequences, its plain version's, and the bytes
    bound (each valid K and V row of D elements read once).  ``library``:
    also SDPA on K/V gathered beforehand, masked to each sequence's length
    and window (a yardstick, not the same inputs: the gather is not
    timed)."""
    import torch
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    B, Lt, bf16 = len(lengths), sz.timing_layers, torch.bfloat16
    kpool = _rand(gen, (Lt, B * NP, ps, KVH, D), bf16, dev)
    vpool = _rand(gen, (Lt, B * NP, ps, KVH, D), bf16, dev)
    q = _rand(gen, (B, H, D), bf16, dev)
    pt = torch.arange(B * NP, dtype=torch.int32, device=dev).reshape(B, NP)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ms = time_ms(dev, [lambda l=l: paged_attention(
        q, kpool[l], vpool[l], pt, ln, window=window) for l in range(Lt)],
        sz.timing_iters)
    plain = time_ms(dev, [lambda l=l: paged_attention_ref(
        q, kpool[l], vpool[l], pt, ln, window=window) for l in range(Lt)],
        max(4, sz.timing_iters // 5))
    lib = None
    if library:
        S = NP * ps
        kg = kpool[0][pt.long()].reshape(B, S, KVH, D).transpose(1, 2)
        vg = vpool[0][pt.long()].reshape(B, S, KVH, D).transpose(1, 2)
        qg = q.reshape(B, KVH, H // KVH, D)
        pos = torch.arange(S, device=dev)[None, :]
        mask = pos < ln[:, None]
        if window:
            mask &= pos >= ln[:, None] - window
        mask = mask[:, None, None, :]
        lib = time_ms(dev, [lambda: torch.nn.functional
                            .scaled_dot_product_attention(
                                qg, kg, vg, attn_mask=mask)],
                      sz.timing_iters)
        del kg, vg
    rows = sum(min(n, window) if window else n for n in lengths)
    nbytes = (2 * rows * KVH * D + 2 * B * H * D) * 2 + pt.numel() * 4 + B * 4
    t_ops = 4 * rows * H * D / PEAK_FLOPS["bfloat16"]
    del kpool, vpool
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= t_ops
            else "operations", "bytes": nbytes}


def _head_dim_cases(gen, dev, sz: Sizes) -> dict:
    """``paged_attention`` at the head dims that run the next instance up
    (80 and 112 on the 128 instance): H2O-Danube-1.8B's heads (H=32, KVH=8,
    D=80) with a window shorter than the context, Zamba2-7B's (H=32,
    KVH=32, D=112); f32 and bf16 at every cluster size against the plain
    version at the serving shape (4 sequences, 256-token pages, ragged) and
    at batch 1, then bf16 device times (:func:`_timed_attn`, SDPA on
    pre-gathered K/V beside them)."""
    import torch
    from repro_torch.configs import get_config
    out = {}
    B, NP, ps = sz.max_batch, sz.pages_per_seq, 256
    ragged = [max(1, int(ps * NP * f)) for f in (0.2, 0.3, 0.6, 1.0)][:B]
    for arch, window in ((sz.danube_arch, sz.danube_kernel_window),
                         (sz.zamba_arch, 0)):
        c = get_config(arch)
        H, KVH, D = c.n_heads, c.n_kv_heads, c.head_dim
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            errs[name] = max(
                _attn_case(gen, dev, B, H, KVH, D, ps, NP, dt, lengths=ragged,
                           window=window),
                _attn_case(gen, dev, 1, H, KVH, D, ps, NP, dt,
                           lengths=[ps * NP - 5], window=window))
        out[f"head_dim_{D}"] = {
            "arch": c.name, "H": H, "KVH": KVH, "D": D, "ps": ps, "NP": NP,
            "lengths": ragged, "window": window,
            "masked_by_window": window > 0 and max(ragged) > window,
            "max_abs_err": errs, "cluster_sizes_checked": list(SPLITS),
            "instance_head_dim": 128,
            "library": "SDPA on pre-gathered K/V, length and window mask",
            **_timed_attn(gen, dev, sz, H, KVH, D, ps, NP, ragged, window,
                          library=True)}
    return out


def _page_size_cases(gen, dev, sz: Sizes, cfg) -> dict:
    """Page sizes a bulk segment cannot serve (row copies by ``cp.async``):
    ``small_page_sizes`` at D 16 and 128, f32 and bf16, every cluster size,
    against the plain version; then the cost of small pages: bf16 device
    time of the serving shape (Qwen3-14B's heads, 4 x 1024-token contexts)
    at 256-token pages (bulk), 16 (bulk, 16-row segments) and each small
    size."""
    import torch
    from repro_torch.kernels.paged_attention import \
        paged_attention as pa_kernel
    errs, modes = {}, {}
    for D in (16, 128):
        for ps in sz.small_page_sizes:
            NP = max(2, -(-70 // ps))
            for dt in (torch.float32, torch.bfloat16):
                name = str(dt).split(".")[-1]
                seg = pa_kernel.bulk_segment(ps, D, dt)
                modes[f"D{D}_ps{ps}_{name}"] = \
                    f"bulk, {seg}-row segments" if seg else "row copies"
                e = _attn_case(gen, dev, 2, 8, 2, D, ps, NP, dt)
                errs[f"D{D}_ps{ps}_{name}"] = e
    require(any(m == "row copies" for m in modes.values()),
            f"no case took the row copies: {modes}")
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    context = sz.pages_per_seq * cfg.kv_page_tokens
    cost = {}
    for ps in (256, 16) + tuple(sz.small_page_sizes):
        NP = -(-context // ps)
        t = _timed_attn(gen, dev, sz, H, KVH, D, ps, NP,
                        [context] * sz.max_batch)
        cost[str(ps)] = {"ms": t["ms"], "bound_ms": t["bound_ms"],
                         "segment_rows": pa_kernel.bulk_segment(
                             ps, D, torch.bfloat16)}
    return {"max_abs_err": errs, "copies": modes,
            "bf16_ms_by_page_size": cost,
            "cost_shape": {"B": sz.max_batch, "H": H, "KVH": KVH, "D": D,
                           "context": context}}


def _copy_plan(dev, n: int, row_bytes: int) -> tuple:
    """The page copies' plan for ``n`` rows of ``row_bytes`` on ``dev``."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.page_pack import page_pack as pk
    return pk.copy_plan(n, row_bytes, sm_count(dev.index or 0))


def _copy_blocks(dev, n: int, row_bytes: int) -> int:
    """Blocks of the copy's grid: the bulk plan's, or the word loop's one
    block a (row, 16 KB piece) of 16-byte words (csrc/page_pack.cu)."""
    blocks = _copy_plan(dev, n, row_bytes)[2]
    return blocks or n * -(-row_bytes // 16384)


def _copy_floor_ms(dev, n: int, row_bytes: int, iters: int) -> float:
    """An empty kernel launched with the copy's grid, timed as the copy
    is: the launch floor under its time."""
    from repro_torch.kernels.page_pack import page_pack as pk
    blocks = _copy_blocks(dev, n, row_bytes)
    return time_ms(dev, [lambda: pk.empty_launch(blocks, dev)], iters)


def _bulk_copy_cases(gen, dev, sz: Sizes, cfg) -> dict:
    """The bulk copies (copies of 16 MB and more) where they clamp and
    where a row ends in a shorter piece: a slot's rows of every layer of
    Qwen3-14B (512 KB) and of H2O-Danube-1.8B (320 KB), whose rows split
    into whole 32 KB pieces, and Danube's rows widened by 16 bytes, whose
    last piece is shorter (no configuration's page row has one).  Indices
    of -1 (row 0), at the pool's end and far past it (the last row).
    Gather and scatter against ``page_pack/ref.py`` on the clamped list,
    bit for bit; a scatter's list clamps onto rows that no other index
    names (-1 and one past the pool), and the whole pool is compared, so a
    row written twice, or not at all, shows."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.page_pack import page_pack as pk
    from repro_torch.kernels.page_pack.ops import gather_pages, scatter_pages
    from repro_torch.kernels.page_pack.ref import (page_gather_ref,
                                                   page_scatter_ref)
    danube = get_config(sz.danube_arch)
    cases = [(c.name, c.n_layers,
              c.kv_page_tokens * c.n_kv_heads * c.head_dim)
             for c in (cfg, danube)]
    cases.append((danube.name + " rows + 16 B", danube.n_layers,
                  cases[-1][2] + 8))
    out = {}
    for name, L, E in cases:
        row_bytes = E * 2
        per = sz.pages_per_seq
        n = L * per
        P = 2 * n                          # rows: two slots a layer
        mode, piece, _, _ = _copy_plan(dev, n, row_bytes)
        require(mode == pk.BULK, f"{name}: {n} rows of {row_bytes} B "
                "do not take the bulk copies")
        pool = _rand(gen, (P, E), torch.bfloat16, dev)
        # gather: the slot's rows, three of them replaced by clamped ones
        idx = _slot_rows(L, 2 * per, per, 1, dev)
        idx[0], idx[n // 2], idx[-1] = -1, P, P + 1000
        want = page_gather_ref(pool, idx.clamp(max=P - 1))
        got = gather_pages(pool, idx)
        sync(dev)
        require(torch.equal(got, want), f"page_gather {name} bulk rows, "
                "clamped indices")
        # scatter: rows 1 .. P - 2 once at most, so rows 0 and P - 1 are
        # named only by -1 and the past-the-pool index
        idx = torch.randperm(P - 2, generator=gen, device=dev)[:n] \
            .to(torch.int32) + 1
        idx[0], idx[n // 2] = -1, P + 1000
        blk = _rand(gen, (n, E), torch.bfloat16, dev)
        want = page_scatter_ref(pool.clone(), idx.clamp(max=P - 1), blk)
        res = scatter_pages(pool.clone(), idx, blk)
        sync(dev)
        require(torch.equal(res, want), f"page_scatter {name} bulk rows, "
                "clamped indices")
        out[name] = {"rows": n, "row_bytes": row_bytes, "pool_rows": P,
                     "piece_bytes": piece,
                     "last_piece_bytes": row_bytes % piece or piece,
                     "gather_indices": "-1, pool_rows, pool_rows + 1000",
                     "scatter_indices": "-1, pool_rows + 1000",
                     "gather_exact": True, "scatter_exact": True}
        del pool, blk, got, res, want
    require(any(v["last_piece_bytes"] < v["piece_bytes"]
                for v in out.values()), "no bulk case had a shorter piece")
    return out


def _hybrid_copies(gen, dev, sz: Sizes, iters: int) -> dict:
    """Page gather / scatter at Zamba2-7B's KV rows (``serve_hybrid``): one
    sequence's pages of every shared-attention site <-> its batch slot,
    rows of 256 x 32 x 112 bf16 (1,835,008 B) from a pool of 13 sites x 16
    pages, as the engine's ``k_pool`` / ``v_pool`` viewed (G·P, E).  Gather
    and scatter against ``page_pack/ref.py`` bit for bit on the slot's
    rows, then with a -1 index and an index past the pool (clamped, as the
    reference clamps); then device times against ``index_select`` /
    ``index_copy_``, an empty kernel with the copy's grid and the bytes
    bound.  The pool (382 MB) and the two blocks (95 MB each) exceed the
    L2, so no copy of them is cycled."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.page_pack.ops import gather_pages, scatter_pages
    from repro_torch.kernels.page_pack.ref import (page_gather_ref,
                                                   page_scatter_ref)
    from repro_torch.models.hybrid import group_layout
    zcfg = get_config(sz.zamba_arch)
    G = group_layout(zcfg)[0]
    P, per = sz.max_batch * sz.pages_per_seq, sz.pages_per_seq
    E = zcfg.kv_page_tokens * zcfg.n_kv_heads * zcfg.head_dim
    pool = _rand(gen, (G * P, E), torch.bfloat16, dev)
    idx = _slot_rows(G, P, per, min(1, sz.max_batch - 1), dev)
    n = idx.numel()
    blocks = [_rand(gen, (n, E), torch.bfloat16, dev) for _ in range(2)]
    require(torch.equal(gather_pages(pool, idx), page_gather_ref(pool, idx)),
            "page_gather Zamba2 rows")
    require(torch.equal(scatter_pages(pool.clone(), idx, blocks[0]),
                        page_scatter_ref(pool.clone(), idx, blocks[0])),
            "page_scatter Zamba2 rows")
    bad = idx.clone()
    bad[0], bad[n // 2] = -1, G * P + 7         # onto rows no other names
    bad[1:n // 2] = torch.arange(1, n // 2, dtype=bad.dtype, device=dev)
    clamped = bad.clamp(max=G * P - 1)
    require(torch.equal(gather_pages(pool, bad),
                        page_gather_ref(pool, clamped)),
            "page_gather Zamba2 rows, clamped indices")
    require(torch.equal(scatter_pages(pool.clone(), bad, blocks[1]),
                        page_scatter_ref(pool.clone(), clamped, blocks[1])),
            "page_scatter Zamba2 rows, clamped indices")
    sync(dev)
    il = idx.long()
    g_ms = time_ms(dev, [lambda b=b: gather_pages(pool, idx, out=b)
                         for b in blocks], iters)
    s_ms = time_ms(dev, [lambda b=b: scatter_pages(pool, idx, b)
                         for b in blocks], iters)
    g_plain = time_ms(dev, [lambda b=b: page_gather_ref(pool, idx, out=b)
                            for b in blocks], iters)
    s_plain = time_ms(dev, [lambda b=b: page_scatter_ref(pool, idx, b)
                            for b in blocks], iters)
    g_lib = time_ms(dev, [lambda b=b: torch.index_select(pool, 0, il, out=b)
                          for b in blocks], iters)
    s_lib = time_ms(dev, [lambda b=b: pool.index_copy_(0, il, b)
                          for b in blocks], iters)
    floor = _copy_floor_ms(dev, n, E * 2, iters)
    del pool, blocks
    nbytes = 2 * n * E * 2 + n * 4
    return {"arch": zcfg.name, "row_bytes": E * 2, "rows": n,
            "pool_rows": G * P, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "gather_ms": g_ms, "scatter_ms": s_ms,
            "gather_plain_ms": g_plain, "scatter_plain_ms": s_plain,
            "gather_library_ms": g_lib, "scatter_library_ms": s_lib,
            "empty_kernel_ms": floor, "plan": _copy_plan_of(dev, n, E * 2),
            "indices_checked": "the slot's rows; -1 and pool_rows + 7",
            "gather_exact": True, "scatter_exact": True}


def phase_kernels(dev, sz: Sizes, cfg):
    import torch
    from repro_torch.kernels.page_pack.ops import gather_pages, scatter_pages
    from repro_torch.kernels.page_pack.ref import (page_gather_ref,
                                                   page_scatter_ref)
    from repro_torch.kernels.paged_attention import \
        paged_attention as pa_kernel
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {"paged_attention": 0.0, "page_gather": 0.0, "page_scatter": 0.0}
    n_cases = 0

    # ---- kernel 1, small shapes (the CPU tests' cases) --------------------
    for (B, H, KVH, D, ps, NP) in [(1, 4, 4, 16, 4, 2), (2, 8, 2, 32, 8, 3),
                                   (3, 8, 1, 64, 8, 4), (2, 16, 8, 128, 16, 2),
                                   (2, 10, 2, 32, 8, 3), (2, 24, 2, 64, 8, 5)]:
        for dt in (f32, bf16):
            e = _attn_case(gen, dev, B, H, KVH, D, ps, NP, dt)
            errs["paged_attention"] = max(errs["paged_attention"], e)
            n_cases += 1
    for w in (8, 16):                                   # window masking
        e = _attn_case(gen, dev, 2, 8, 2, 32, 8, 4, f32, lengths=[32, 16],
                       window=w)
        errs["paged_attention"] = max(errs["paged_attention"], e)
        n_cases += 1
    # unmapped pages: -1 entries contribute nothing
    q = _rand(gen, (1, 4, 16), f32, dev)
    kp = _rand(gen, (4, 4, 4, 16), f32, dev)
    vp = _rand(gen, (4, 4, 4, 16), f32, dev)
    ln = torch.tensor([8], dtype=torch.int32, device=dev)
    a = paged_attention(q, kp, vp, torch.tensor(
        [[0, 1, -1, -1]], dtype=torch.int32, device=dev), ln)
    b = paged_attention(q, kp, vp, torch.tensor(
        [[0, 1, 2, 3]], dtype=torch.int32, device=dev), ln)
    sync(dev)
    check_close(a, b, 1e-6, "paged_attention unmapped pages")
    ln16 = torch.tensor([16], dtype=torch.int32, device=dev)
    hole = torch.tensor([[0, -1, 2, 3]], dtype=torch.int32, device=dev)
    e = _attn_splits("paged_attention unmapped page inside the context", q,
                     kp, vp, hole, ln16)
    errs["paged_attention"] = max(errs["paged_attention"], e)
    n_cases += 2
    # rows with no valid position: the mean of the V rows read, as the
    # reference (length 0; every page unmapped; the window's pages unmapped)
    q = _rand(gen, (2, 4, 16), f32, dev)
    kp = _rand(gen, (6, 4, 2, 16), f32, dev)
    vp = _rand(gen, (6, 4, 2, 16), f32, dev)
    for table, lens, w in ([[0, 1, 2], [3, 4, 5]], [0, 9], 0), \
            ([[0, 1, 2], [-1, -1, -1]], [5, 9], 0), \
            ([[0, 1, 2], [3, -1, -1]], [5, 9], 2):
        pt = torch.tensor(table, dtype=torch.int32, device=dev)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        e = _attn_splits(f"paged_attention no valid position {table} "
                         f"{lens} window={w}", q, kp, vp, pt, ln, w)
        errs["paged_attention"] = max(errs["paged_attention"], e)
        n_cases += 1

    # a split that sees only masked rows (its page unmapped, or before the
    # window): 256-row context, 64-token pages, four splits
    q = _rand(gen, (1, 10, 128), bf16, dev)
    kp = _rand(gen, (4, 64, 2, 128), bf16, dev)
    vp = _rand(gen, (4, 64, 2, 128), bf16, dev)
    ln = torch.tensor([256], dtype=torch.int32, device=dev)
    for table, w in (([[0, -1, 2, 3]], 0), ([[0, 1, 2, 3]], 40),
                     ([[-1, -1, 2, -1]], 0)):
        pt = torch.tensor(table, dtype=torch.int32, device=dev)
        for dt in (bf16, f32):
            e = _attn_splits(f"paged_attention masked split {table} "
                             f"window={w}", q.to(dt), kp.to(dt), vp.to(dt),
                             pt, ln, w)
            errs["paged_attention"] = max(errs["paged_attention"], e)
            n_cases += 1

    # ---- kernel 1, the serving path's shapes ------------------------------
    H, KVH, D, ps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.kv_page_tokens
    B, NP = sz.max_batch, sz.pages_per_seq
    ragged = [max(1, int(ps * NP * f)) for f in
              (0.2, 0.3, 0.6, 1.0, 0.45, 0.8, 0.1, 0.7)][:B]
    main_err = 0.0
    for dt in (bf16, f32):
        e = _attn_case(gen, dev, B, H, KVH, D, ps, NP, dt, lengths=ragged)
        e1 = _attn_case(gen, dev, 1, H, KVH, D, ps, NP, dt, lengths=[1])
        e2 = _attn_case(gen, dev, B, H, KVH, D, ps, NP, dt,
                        lengths=[1] * B)              # idle slots: length 1
        if dt == bf16:
            main_err = max(e, e1, e2)
        errs["paged_attention"] = max(errs["paged_attention"], e, e1, e2)
        n_cases += 3

    # timing: a stacked pool of several layers, one layer per call
    Lt = sz.timing_layers
    P = B * NP
    kpool = _rand(gen, (Lt, P, ps, KVH, D), bf16, dev)
    vpool = _rand(gen, (Lt, P, ps, KVH, D), bf16, dev)
    q = _rand(gen, (B, H, D), bf16, dev)
    pt = torch.arange(P, dtype=torch.int32, device=dev).reshape(B, NP)
    ln = torch.tensor(ragged, dtype=torch.int32, device=dev)
    it = sz.timing_iters
    attn_ms = time_ms(dev, [lambda l=l: paged_attention(
        q, kpool[l], vpool[l], pt, ln) for l in range(Lt)], it)
    attn_plain_ms = time_ms(dev, [lambda l=l: paged_attention_ref(
        q, kpool[l], vpool[l], pt, ln) for l in range(Lt)], max(4, it // 5))
    rows = int(sum(ragged))
    attn_bytes = (2 * rows * KVH * D + 2 * B * H * D) * 2 + pt.numel() * 4 \
        + ln.numel() * 4
    attn_flops = 4 * rows * H * D                 # q.k and p.v multiply-adds
    attn_ops_s = attn_flops / PEAK_FLOPS["bfloat16"]
    attn_bound = max(attn_bytes / HBM_BYTES_PER_S, attn_ops_s)
    q1 = q[:1].contiguous()
    pt1 = pt[:1].contiguous()
    ln1 = ln[3 % B:3 % B + 1].contiguous()
    attn_b1_ms = time_ms(dev, [lambda l=l: paged_attention(
        q1, kpool[l], vpool[l], pt1, ln1) for l in range(Lt)], it)
    # yardstick only, not the same inputs: SDPA on K/V gathered beforehand
    S = NP * ps
    kg = kpool[0][pt.long()].reshape(B, S, KVH, D).transpose(1, 2)
    vg = vpool[0][pt.long()].reshape(B, S, KVH, D).transpose(1, 2)
    qg = q.reshape(B, KVH, H // KVH, D)
    mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])[:, None,
                                                               None, :]
    sdpa_ms = time_ms(dev, [lambda: torch.nn.functional
                            .scaled_dot_product_attention(
                                qg, kg, vg, attn_mask=mask)], it)
    # determinism: the cluster combine has one order, so two calls agree
    # bit for bit
    require(torch.equal(paged_attention(q, kpool[0], vpool[0], pt, ln),
                        paged_attention(q, kpool[0], vpool[0], pt, ln)),
            "paged_attention: two calls differ (serving shape)")
    tile = pa_kernel.TILE_ROWS[bf16]
    n_serve = pa_kernel.plan_splits(dev.index or 0, B, KVH, H // KVH, D, NP,
                                    ps, bf16)
    n_b1 = pa_kernel.plan_splits(dev.index or 0, 1, KVH, H // KVH, D, NP, ps,
                                 bf16)
    active = {n: pa_kernel.active_clusters(dev.index or 0, n, D, H // KVH,
                                           bf16) for n in (1, 2, 4, 8)}
    del kpool, vpool, kg, vg

    # ---- kernel 1 at the model's native context: B=1, 32,768 tokens -------
    long = _long_context(gen, dev, sz, H, KVH, D, ps)
    errs["paged_attention_long_context"] = long.pop("max_abs_err_by_dtype")
    n_cases += 2

    # ---- kernel 1 at head dims 80 and 112, and at small page sizes --------
    wide = _head_dim_cases(gen, dev, sz)
    errs["paged_attention_head_dims"] = {k: v["max_abs_err"]
                                         for k, v in wide.items()}
    n_cases += 4 * len(wide)
    small_pages = _page_size_cases(gen, dev, sz, cfg)
    errs["paged_attention_page_sizes"] = small_pages["max_abs_err"]
    n_cases += len(small_pages["max_abs_err"])

    # ---- kernels 2 and 3, small shapes -----------------------------------
    for (Pn, n, E) in [(8, 4, 32), (64, 16, 128), (16, 16, 64), (8, 5, 7),
                       (8, 5, 3)]:
        for dt in (f32, bf16, torch.int32):
            if dt == torch.int32:
                pool = torch.randint(0, 100, (Pn, E), generator=gen,
                                     device=dev, dtype=dt)
            else:
                pool = _rand(gen, (Pn, E), dt, dev)
            idx = torch.randperm(Pn, generator=gen, device=dev)[:n] \
                .to(torch.int32)
            idx[0] = -1
            got = gather_pages(pool, idx)
            sync(dev)
            require(torch.equal(got, page_gather_ref(pool, idx)),
                    f"page_gather P{Pn} n{n} E{E} {dt}")
            blk = got.flip(0).contiguous()
            want = page_scatter_ref(pool.clone(), idx[1:], blk[1:])
            out = scatter_pages(pool.clone(), idx[1:], blk[1:].contiguous())
            sync(dev)
            require(torch.equal(out, want),
                    f"page_scatter P{Pn} n{n} E{E} {dt}")
            n_cases += 2
    pool = _rand(gen, (16, 32), f32, dev)
    before = pool.clone()
    idx = torch.tensor([2, 9, 14], dtype=torch.int32, device=dev)
    blk = _rand(gen, (3, 32), f32, dev)
    scatter_pages(pool, idx, blk)
    sync(dev)
    keep = [r for r in range(16) if r not in (2, 9, 14)]
    require(torch.equal(pool[keep], before[keep])
            and torch.equal(pool[idx.long()], blk),
            "page_scatter touched rows it was not given")
    pool = _rand(gen, (32, 8, 16), f32, dev)
    idx = torch.tensor([5, 1, 30, 7], dtype=torch.int32, device=dev)
    pages = gather_pages(pool, idx)
    pool2 = scatter_pages(torch.zeros_like(pool), idx, pages)
    sync(dev)
    want = torch.zeros_like(pool)
    want[idx.long()] = pool[idx.long()]
    require(torch.equal(pool2, want), "gather∘scatter round trip")
    n_cases += 2

    # ---- kernels 2 and 3, the serving path's shape ------------------------
    # one sequence's pages of every layer <-> its batch slot: rows of
    # E = ps·KVH·D elements in the decode cache viewed as (L·P, E)
    E = ps * KVH * D
    L = sz.serve_layers or cfg.n_layers
    per_seq = NP
    pool = _rand(gen, (L * P, E), bf16, dev)
    idx = _slot_rows(L, P, per_seq, min(2, B - 1), dev)
    n = idx.numel()
    blocks = [_rand(gen, (n, E), bf16, dev) for _ in range(2)]
    got = gather_pages(pool, idx, out=blocks[0])
    sync(dev)
    require(torch.equal(got, page_gather_ref(pool, idx)),
            "page_gather serving shape")
    want = page_scatter_ref(pool.clone(), idx, blocks[1])
    out = scatter_pages(pool.clone(), idx, blocks[1])
    sync(dev)
    require(torch.equal(out, want), "page_scatter serving shape")
    del want, out
    n_cases += 2
    idx_l = idx.long()
    copy_it = max(4, it // 2)
    gather_ms = time_ms(dev, [lambda b=b: gather_pages(pool, idx, out=b)
                              for b in blocks], copy_it)
    gather_plain = time_ms(dev, [lambda b=b: page_gather_ref(pool, idx, out=b)
                                 for b in blocks], copy_it)
    gather_lib = time_ms(dev, [lambda b=b: torch.index_select(
        pool, 0, idx_l, out=b) for b in blocks], copy_it)
    scatter_ms = time_ms(dev, [lambda b=b: scatter_pages(pool, idx, b)
                               for b in blocks], copy_it)
    scatter_plain = time_ms(dev, [lambda b=b: page_scatter_ref(pool, idx, b)
                                  for b in blocks], copy_it)
    scatter_lib = time_ms(dev, [lambda b=b: pool.index_copy_(0, idx_l, b)
                                for b in blocks], copy_it)
    copy_bytes = 2 * n * E * pool.element_size() + n * 4
    copy_bound = copy_bytes / HBM_BYTES_PER_S
    copy_floor = _copy_floor_ms(dev, n, E * pool.element_size(), copy_it)
    copy_plan = _copy_plan_of(dev, n, E * pool.element_size())
    del pool, blocks

    # ---- kernels 2 and 3 at DeepSeek-V3's latent-pool rows ----------------
    latent = _latent_copies(gen, dev, sz, copy_it)
    n_cases += 2 * len(latent)

    # ---- kernels 2 and 3 at Zamba2-7B's KV rows ---------------------------
    zamba_rows = _hybrid_copies(gen, dev, sz, copy_it)
    n_cases += 4

    # ---- kernels 2 and 3, bulk copies that clamp and end in short pieces --
    bulk_cases = _bulk_copy_cases(gen, dev, sz, cfg)
    n_cases += 2 * len(bulk_cases)

    src = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    table = [
        {"name": "paged_attention", "route": "cuda",
         "source": src + "paged_attention.cu",
         "replaces": ref + "paged_attention/paged_attention.py:81",
         "launches": 0, "max_abs_err": main_err, "ms": attn_ms,
         "plain_ms": attn_plain_ms, "bound_ms": attn_bound * 1e3,
         "bound_by": "bytes" if attn_bytes / HBM_BYTES_PER_S >= attn_ops_s
         else "operations",
         "library_ms": None, "sdpa_on_pregathered_kv_ms": sdpa_ms,
         "batch1_ms": attn_b1_ms, "bytes": attn_bytes,
         "n_splits": n_serve, "batch1_n_splits": n_b1,
         "active_clusters_by_size": active,
         "design": "split-KV over a thread-block cluster (DSMEM combine), "
         "a producer warp's cp.async.bulk.tensor copies (a page segment "
         f"each) into an mbarrier ring of {tile}-row stages, consumer warps "
         "split the tokens; pages a segment cannot serve copied row by row "
         "(cp.async); head dims 80 and 112 on the 128 instance",
         "long_context": long, **wide, "small_pages": small_pages,
         "shape": {"B": B, "H": H, "KVH": KVH, "D": D, "ps": ps, "NP": NP,
                   "lengths": ragged, "dtype": "bfloat16"}},
        {"name": "page_gather", "route": "cuda", "source": src + "page_pack.cu",
         "replaces": ref + "page_pack/page_pack.py:25", "launches": 0,
         "max_abs_err": 0.0, "ms": gather_ms, "plain_ms": gather_plain,
         "bound_ms": copy_bound * 1e3, "bound_by": "bytes",
         "library_ms": gather_lib, "library": "torch.index_select",
         "bytes": copy_bytes, "empty_kernel_ms": copy_floor,
         "plan": copy_plan,
         "shape": {"pool": [L * P, E], "n": n, "dtype": "bfloat16"},
         "latent_pools": {k: {f: v[f] for f in v if "scatter" not in f}
                          for k, v in latent.items()},
         "zamba2_rows": {f: v for f, v in zamba_rows.items()
                         if "scatter" not in f},
         "bulk_cases": bulk_cases},
        {"name": "page_scatter", "route": "cuda",
         "source": src + "page_pack.cu",
         "replaces": ref + "page_pack/page_pack.py:53", "launches": 0,
         "max_abs_err": 0.0, "ms": scatter_ms, "plain_ms": scatter_plain,
         "bound_ms": copy_bound * 1e3, "bound_by": "bytes",
         "library_ms": scatter_lib, "library": "Tensor.index_copy_",
         "bytes": copy_bytes, "empty_kernel_ms": copy_floor,
         "plan": copy_plan,
         "shape": {"pool": [L * P, E], "n": n, "dtype": "bfloat16"},
         "latent_pools": {k: {f: v[f] for f in v if "gather" not in f}
                          for k, v in latent.items()},
         "zamba2_rows": {f: v for f, v in zamba_rows.items()
                         if "gather" not in f},
         "bulk_cases": bulk_cases},
    ]
    # the time_ms calls above, in the order they ran
    names = ["paged_attention", "paged_attention_plain",
             "paged_attention_batch1", "sdpa_on_pregathered_kv",
             "paged_attention_long_context",
             "paged_attention_long_context_plain"] + [
                 f"paged_attention_{k}{p}" for k in wide
                 for p in ("", "_plain", "_sdpa")] + [
                 f"paged_attention_page_size_{ps}{p}"
                 for ps in small_pages["bf16_ms_by_page_size"]
                 for p in ("", "_plain")] + [
                 "page_gather", "page_gather_plain", "index_select",
                 "page_scatter", "page_scatter_plain", "index_copy_",
                 "page_copy_empty_kernel"] + [
                 f"{what}_{pool}" for pool in list(latent) + ["zamba2"]
                 for what in ("page_gather", "page_scatter",
                              "page_gather_plain", "page_scatter_plain",
                              "index_select", "index_copy_",
                              "empty_kernel")]
    flash_rows, flash_errs, flash_cases = phase_flash(dev, sz, cfg, names)
    table += flash_rows
    errs["flash_attention (fwd, grads)"] = flash_errs
    emit("kernels", cases=n_cases + flash_cases, max_abs_err_all_cases=errs,
         timing="device time of the call's kernels (torch.profiler)",
         cuda_event_ms_per_call=dict(zip(names, EVENTS_MS)),
         tolerance={"float32": TOL["float32"], "bfloat16": TOL["bfloat16"],
                    "flash_grads_float32": GRAD_TOL_F32,
                    "flash_bfloat16": "2e-2 relative L2 error per row (one "
                    "position of one head; rows' rms floored at 5e-4) "
                    "against the plain forward and the plain backward given "
                    "the kernel's output; gradients also within 2e-2 x "
                    "max|ref| of autograd", "copies": "exact"},
         kernels=table)
    return table


# ------------------------------------------------------- phase: decode parity
def phase_decode_parity(dev, sz: Sizes, cfg):
    """One decode step over a warm ragged cache, kernel path vs plain path.

    bf16 logits, atol = rtol = 5e-2: the two attention outputs differ by one
    bf16 rounding (2^-8 relative) and that difference passes through two
    layers and the vocabulary projection."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decoder

    pcfg = dataclasses.replace(cfg, n_layers=sz.parity_layers)
    params = decoder.init_params(pcfg, 1, device=dev)
    B, ps = sz.max_batch, pcfg.kv_page_tokens
    max_len = sz.pages_per_seq * ps
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    base = decoder.init_decode_cache(pcfg, B, max_len, device=dev)
    for name in ("k_pool", "v_pool"):
        base[name].copy_(_rand(gen, base[name].shape, base[name].dtype, dev))
    fracs = (0.3, 0.05, 0.55, 0.97, 0.4, 0.7, 0.2, 0.8)
    base["lengths"] = torch.tensor(
        [max(1, int(max_len * f)) - 1 for f in fracs[:B]], dtype=torch.int32,
        device=dev)
    tokens = torch.randint(0, pcfg.vocab_size, (B, 1), generator=gen,
                           device=dev)

    def clone(c):
        return {k: v.clone() for k, v in c.items()}

    before = launch_counts()["paged_attention"]
    logits_k, cache_k = decoder.decode_step(params, pcfg, clone(base), tokens)
    sync(dev)
    launched = launch_counts()["paged_attention"] - before
    if dev.type == "cuda":
        require(launched == pcfg.n_layers,
                f"decode_step launched the kernel {launched} times, expected "
                f"{pcfg.n_layers}")
    kernel_fn = attn_mod.paged_attention
    attn_mod.paged_attention = paged_attention_ref      # plain path, on card
    try:
        logits_p, cache_p = decoder.decode_step(params, pcfg, clone(base),
                                                tokens)
    finally:
        attn_mod.paged_attention = kernel_fn
    sync(dev)
    require(tuple(logits_k.shape) == (B, 1, pcfg.vocab_size), "logits shape")
    err = check_close(logits_k, logits_p, 5e-2, "decode_step logits")
    # layer 0 writes its K/V before any attention ran: identical; deeper
    # layers see the attention outputs, which differ by bf16 roundings
    require(torch.equal(cache_k["k_pool"][0], cache_p["k_pool"][0])
            and torch.equal(cache_k["lengths"], cache_p["lengths"]),
            "decode_step cache update differs between the two paths")
    check_close(cache_k["v_pool"], cache_p["v_pool"], 5e-2,
                "decode_step V pools")
    agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    emit("decode_parity", layers=pcfg.n_layers, d_model=pcfg.d_model,
         vocab=pcfg.vocab_size, batch=B,
         lengths=[int(x) + 1 for x in base["lengths"].tolist()],
         max_abs_err=err, tolerance=5e-2, logits_abs_max=float(
             logits_p.float().abs().max()), argmax_agree=agree,
         kernel_launches=launched)
    return params, pcfg


# ---------------------------------------------------------- phase: dist_local
def phase_dist_local(dev, sz: Sizes, cfg, table):
    """The shard-local paged decode at Qwen3-14B's decode shape: the body
    that ``models.attention._paged_update_and_attend_dist`` runs on each
    data rank (``paged_shard_local``), here for two data ranks in one
    process with no process group.  Rank r takes its ``max_batch / 2``
    rows, its slice of a pool of 2 x ``p_local`` frames (a view: rank 1's
    at a non-zero offset) and its rows of the global page table, rebased
    to the slice; rank r's sequences own shuffled frames of slice r (the
    engine's identity layout), so rank 1 holds sequences' current pages.
    Counters are zeroed just before the ranks' calls and read just after:
    one paged-attention launch a rank.  Then each rank's output and its
    pool slices are held to the plain version (the same body on CPU copies,
    the kernels phase's bf16 tolerance; pools exactly) and to the
    unsharded kernel call on the rank's rows over the whole pool and the
    global table (pools exactly)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models.attention import (_paged_update_and_attend,
                                              paged_shard_local)

    n_ranks, bf16 = 2, torch.bfloat16
    H, KVH, D, ps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.kv_page_tokens
    B, NP = sz.max_batch, sz.pages_per_seq
    rows, p_local = B // n_ranks, B // n_ranks * NP
    # the kernels phase's lengths on the serving path's shapes
    lengths = [max(1, int(ps * NP * f)) for f in
               (0.2, 0.3, 0.6, 1.0, 0.45, 0.8, 0.1, 0.7)][:B]
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    cpu_gen = torch.Generator().manual_seed(22)
    q1 = _rand(gen, (B, H, D), bf16, dev)
    k1, v1 = (_rand(gen, (B, KVH, D), bf16, dev) for _ in range(2))
    k_pool, v_pool = (_rand(gen, (n_ranks * p_local, ps, KVH, D), bf16, dev)
                      for _ in range(2))
    pt = torch.full((B, NP), -1, dtype=torch.int32)
    for r in range(n_ranks):
        frames = r * p_local + torch.randperm(p_local, generator=cpu_gen)
        for i in range(rows):
            used = -(-lengths[r * rows + i] // ps)
            pt[r * rows + i, :used] = frames[i * NP:i * NP + used]
    pt = pt.to(dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    k0, v0 = k_pool.clone(), v_pool.clone()

    def shard(r):
        b, f = slice(r * rows, (r + 1) * rows), \
            slice(r * p_local, (r + 1) * p_local)
        return b, f

    sync(dev)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    outs = []
    for r in range(n_ranks):
        b, f = shard(r)
        outs.append(paged_shard_local(q1[b], k1[b], v1[b], k_pool[f],
                                      v_pool[f], pt[b], ln[b], 0, r,
                                      p_local))
    sync(dev)
    counts = kernels.launch_counts()
    ranks_s = time.perf_counter() - t0
    require(dev.type != "cuda" or counts["paged_attention"] == n_ranks,
            f"dist_local: paged_attention launches {counts}")
    require(outs[1][1].storage_offset() > 0
            and outs[1][1].data_ptr() == k_pool[shard(1)[1]].data_ptr(),
            "dist_local: rank 1 did not write its pool slice in place")

    ku, vu = k0.clone(), v0.clone()
    kc, vc = (x.to("cpu", copy=True) for x in (k0, v0))
    errs = {"plain": 0.0, "unsharded": 0.0}
    identical = True
    for r in range(n_ranks):
        b, f = shard(r)
        out_u, _, _ = _paged_update_and_attend(q1[b], k1[b], v1[b], ku, vu,
                                               pt[b], ln[b], 0)
        out_p, kp_p, vp_p = paged_shard_local(
            q1[b].cpu(), k1[b].cpu(), v1[b].cpu(), kc[f], vc[f],
            pt[b].cpu(), ln[b].cpu(), 0, r, p_local)
        sync(dev)
        errs["unsharded"] = max(errs["unsharded"], check_close(
            outs[r][0], out_u, TOL["bfloat16"], f"dist_local rank {r} "
            "against the unsharded call"))
        errs["plain"] = max(errs["plain"], check_close(
            outs[r][0].cpu(), out_p, TOL["bfloat16"],
            f"dist_local rank {r} against the plain version"))
        identical = identical and torch.equal(outs[r][0], out_u)
        require(torch.equal(outs[r][1].cpu(), kp_p)
                and torch.equal(outs[r][2].cpu(), vp_p),
                f"dist_local rank {r}: pools differ from the plain version")
    require(torch.equal(k_pool, ku) and torch.equal(v_pool, vu),
            "dist_local: pools differ from the unsharded calls'")
    require(not torch.equal(k_pool, k0), "dist_local: nothing written")
    _add_launches(table, "dist_local", counts, ("paged_attention",))
    emit("dist_local", arch=cfg.name, data_ranks=n_ranks, batch=B,
         heads=H, kv_heads=KVH, head_dim=D, page_tokens=ps,
         pool_frames=n_ranks * p_local, frames_per_rank=p_local,
         lengths=lengths, page_table=pt.tolist(), dtype="bfloat16",
         rank_offsets_bytes=[outs[r][1].storage_offset()
                             * outs[r][1].element_size()
                             for r in range(n_ranks)],
         launches=counts["paged_attention"], ranks_seconds=ranks_s,
         max_abs_err=errs, bit_identical_to_unsharded=identical,
         pools_equal=True)


# ----------------------------------------------------------- phase: dist_step
def _dtensors(tree, shardings):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t, sh: distribute_tensor(t.clone(), sh.mesh,
                                                    sh.placements),
                    tree, shardings)


def _full(tree):
    from repro_torch.distributed.logical import full
    from repro_torch.tree import tree_map
    return tree_map(full, tree)


def _tree_diff(a, b, what: str) -> tuple:
    """(max abs difference over the leaves of two trees, every leaf's bits
    equal), each leaf held to the bf16 tolerance."""
    import torch
    from repro_torch.tree import tree_leaves, tree_names
    err, same = 0.0, True
    for name, x, y in zip(tree_names(a), tree_leaves(a), tree_leaves(b)):
        err = max(err, check_close(x, y, TOL["bfloat16"], f"{what} {name}"))
        same = same and torch.equal(x, y)
    return err, same


def phase_dist_step(dev, sz: Sizes, table):
    """The dense family's decode step and train step with DTensor
    parameters, on a (1 data x 1 model) DeviceMesh over a one-rank group
    (NCCL on the card), under the arch's logical rules, against the same
    steps on the same parameters as plain tensors.  Qwen3-14B at published
    width cut to ``dist_layers``: one decode step at ``max_batch`` over
    256-token pages of random K/V (lengths the kernels phase's), and one
    train step at ``train_batch`` x ``train_seq`` in ``train_microbatches``
    microbatches with remat and AdamW.  Counters are zeroed just before
    each run and read just after: the launches must be equal and non-zero
    (paged attention for decode, flash forward and backward for train),
    which shows the kernels launch from inside the sharded model's
    regions.  Logits, pools, loss and the updated parameters of the two
    runs are held to the bf16 tolerance, and whether their bits are equal
    is reported."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import kernels
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.distributed.sharding import (cache_shardings,
                                                  param_shardings,
                                                  token_sharding)
    from repro_torch.launch.dryrun import logical_rules_for
    from repro_torch.models import decoder
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, make_train_step
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    cfg = _arch_config(sz, sz.arch, n_layers=sz.dist_layers)
    B, ps = sz.max_batch, cfg.kv_page_tokens
    max_len = sz.pages_per_seq * ps
    lengths = [max(1, int(max_len * f)) for f in (0.2, 0.3, 0.6, 0.99,
                                                  0.45, 0.8, 0.1, 0.7)][:B]
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    params = decoder.init_params(cfg, 23, device=dev)
    cache = decoder.init_decode_cache(cfg, B, max_len, device=dev)
    for k in ("k_pool", "v_pool"):
        cache[k].copy_(_rand(gen, cache[k].shape, cache[k].dtype, dev))
    cache["lengths"] = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                           device=dev, dtype=torch.int32)
    batch = torch.randint(0, cfg.vocab_size,
                          (sz.train_batch, sz.train_seq), generator=gen,
                          device=dev, dtype=torch.int32)
    labels = torch.roll(batch, -1, dims=1)
    tcfg = TrainConfig(microbatches=sz.train_microbatches, remat=True,
                       optimizer=AdamWConfig(lr=3e-4))
    step = make_train_step(cfg, tcfg)

    def counted(fn):
        sync(dev)
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        out = fn()
        sync(dev)
        counts = {k: v for k, v in _launches().items() if v}
        return out, counts, time.perf_counter() - t0

    def decode(p, c, tokens):
        logits, new = decoder.decode_step(p, cfg, c, tokens)
        return {"logits": logits, "k_pool": new["k_pool"],
                "v_pool": new["v_pool"], "lengths": new["lengths"]}

    def train(p, batch, labels):
        p, _, metrics = step(p, adamw.init(tcfg.optimizer, p), batch, labels)
        return p, metrics["loss"]

    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        mesh = init_device_mesh(dev.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = logical_rules_for(cfg, mesh)
        runs = {}
        clone = lambda t: tree_map(torch.clone, t)          # noqa: E731
        runs["decode_plain"] = counted(
            lambda: decode(params, clone(cache), tokens))
        p_sh = param_shardings(params, mesh)
        c_sh = cache_shardings(cache, mesh, B)
        dp, dc = _dtensors(params, p_sh), _dtensors(cache, c_sh)
        tok = token_sharding(mesh)
        dtok, dbatch, dlabels = (_dtensors(t, tok)
                                 for t in (tokens, batch, labels))
        with logical_rules(mesh, rules):
            runs["decode_dtensor"] = counted(
                lambda: _full(decode(dp, dc, dtok)))
        del dc
        runs["train_plain"] = counted(
            lambda: train(clone(params), batch, labels))
        with logical_rules(mesh, rules):
            runs["train_dtensor"] = counted(
                lambda: tuple(map(_full, train(dp, dbatch, dlabels))))
        del dp
    finally:
        dist.destroy_process_group()
    del params, cache

    on_card = dev.type == "cuda"
    want = {"decode": ("paged_attention",),
            "train": ("flash_attention", "flash_attention_bwd",
                      "flash_wgmma_fwd")}
    for path, names in want.items():
        plain, dt = runs[f"{path}_plain"][1], runs[f"{path}_dtensor"][1]
        require(plain == dt, f"dist_step {path}: launches {plain} plain, "
                f"{dt} under DTensor")
        require(not on_card or all(dt.get(n, 0) > 0 for n in names),
                f"dist_step {path}: no launch of {names}: {dt}")
    errs, bits = {}, {}
    errs["decode"], bits["decode"] = _tree_diff(
        runs["decode_dtensor"][0], runs["decode_plain"][0], "dist_step")
    (p_d, loss_d), (p_p, loss_p) = runs["train_dtensor"][0], \
        runs["train_plain"][0]
    require(math.isfinite(float(loss_p)), "dist_step: loss not finite")
    errs["loss"] = abs(float(loss_d) - float(loss_p))
    require(errs["loss"] <= TOL["bfloat16"] * (1 + abs(float(loss_p))),
            f"dist_step: loss {float(loss_d)} vs {float(loss_p)}")
    bits["loss"] = bool(torch.equal(loss_d, loss_p))
    errs["params"], bits["params"] = _tree_diff(p_d, p_p, "dist_step params")
    names = want["decode"] + want["train"]
    _add_launches(table, "dist_step", {
        n: runs["decode_dtensor"][1].get(n, 0)
        + runs["train_dtensor"][1].get(n, 0) for n in names}, names)
    emit("dist_step", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, mesh={"data": 1, "model": 1}, backend=backend,
         rules={k: str(v) for k, v in rules.items()}, decode_batch=B,
         page_tokens=ps, lengths=lengths, train_batch=sz.train_batch,
         train_seq=sz.train_seq, microbatches=sz.train_microbatches,
         remat=True,
         launches={k: v[1] for k, v in runs.items()},
         seconds={k: v[2] for k, v in runs.items()},
         max_abs_err=errs, bits_equal=bits, tolerance=TOL["bfloat16"],
         phase_seconds=time.perf_counter() - t_phase)


# ------------------------------------------------ phase: dist_families (A3c)
#: arch -> (decode, train) kernels its plain steps launch on the card
FLASH_TRAIN = ("flash_attention", "flash_attention_bwd", "flash_wgmma_fwd")
DIST_FAMILY_KERNELS = {
    "mixtral_8x7b": (("paged_attention",), FLASH_TRAIN),
    "deepseek_v3_671b": ((), FLASH_TRAIN),
    "zamba2_7b": (("paged_attention",), FLASH_TRAIN),
    "whisper_medium": (("paged_attention", "flash_attention",
                        "flash_decode"), FLASH_TRAIN),
    "xlstm_125m": ((), ()),
}
#: the parent's share and the side process's, the two branches even (with
#: Zamba2 and xLSTM in the side process too, it ran 18 s the longer)
DIST_PARENT = ("mixtral_8x7b", "deepseek_v3_671b", "zamba2_7b", "xlstm_125m")
DIST_SIDE = ("whisper_medium",)


def _family_config(sz: Sizes, arch: str, layers: int):
    """``arch`` at published width cut to ``layers`` (Whisper: encoder
    and decoder; xLSTM: the sLSTM block last)."""
    kw = {"n_layers": layers}
    if arch == "whisper_medium":
        kw["n_enc_layers"] = layers
    if arch == "xlstm_125m":
        kw["slstm_at"] = (layers - 1,)
    return _arch_config(sz, arch, **kw)


def _drawn_cache(gen, dev, cfg, model, B: int, max_len: int, lengths):
    """A decode cache with every float leaf drawn (pools, pinned states;
    an xLSTM normaliser ``n`` at 1 and above, as a run makes it) and
    ``lengths`` set."""
    import torch
    from repro_torch.tree import tree_leaves, tree_names
    cache = model.init_decode_cache(cfg, B, max_len, device=dev)
    for name, t in zip(tree_names(cache), tree_leaves(cache)):
        if t.is_floating_point():
            t.copy_(_rand(gen, t.shape, t.dtype, dev))
            if name.endswith("/n"):
                t.abs_().add_(1.0)
    cache["lengths"] = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return cache


def _wrapped(tree, shardings):
    """Every leaf as a DTensor with its sharding's placements over the same
    storage: on a mesh of one rank a shard is the whole tensor."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t, sh: DTensor.from_local(
        t, sh.mesh, sh.placements, run_check=False), tree, shardings)


def _dist_family(dev, sz: Sizes, arch: str, mesh, counted) -> dict:
    """One family's decode step and train step, DTensor parameters against
    plain ones (``phase_dist_families``)."""
    import torch
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.distributed.sharding import (cache_shardings,
                                                  param_shardings,
                                                  token_sharding)
    from repro_torch.launch.dryrun import logical_rules_for
    from repro_torch.models.registry import model_for
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, make_train_step
    from repro_torch.tree import tree_map

    dec_layers, train_layers = dict(
        (a, (d, t)) for a, d, t in sz.dist_family_depth)[arch]
    tb, ts = dict((a, (b, s)) for a, b, s in sz.dist_family_train)[arch]
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    runs, shapes = {}, {}
    clone = lambda t: tree_map(torch.clone, t)              # noqa: E731
    # decode: the plain step on a copy of the cache, the DTensor step on
    # the cache itself (its leaves wrapped), the parameters shared
    # Mixtral's window (4,096) masks nothing in this context: off, decode
    # takes the paged pools (with it, a ring buffer), as in serve_danube
    cfg = dataclasses.replace(_family_config(sz, arch, dec_layers),
                              sliding_window=0)
    model = model_for(cfg)
    rules = logical_rules_for(cfg, mesh)
    B = sz.max_batch
    max_len = sz.whisper_max_len if cfg.is_encdec \
        else sz.pages_per_seq * cfg.kv_page_tokens
    lengths = [max(1, int(max_len * f)) for f in (0.2, 0.3, 0.6, 0.99,
                                                  0.45, 0.8, 0.1, 0.7)][:B]
    params = model.init_params(cfg, 24, device=dev)
    cache = _drawn_cache(gen, dev, cfg, model, B, max_len, lengths)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                           device=dev, dtype=torch.int32)

    def decode(p, c, t):
        logits, _ = model.decode_step(p, cfg, c, t)
        return {"logits": logits, "cache": c}

    runs["decode_plain"] = counted(
        lambda: decode(params, clone(cache), tokens))
    dp = _wrapped(params, param_shardings(params, mesh))
    dc = _wrapped(cache, cache_shardings(cache, mesh, B))
    dtok = _wrapped({"t": tokens}, {"t": token_sharding(mesh)})["t"]
    with logical_rules(mesh, rules):
        runs["decode_dtensor"] = counted(
            lambda: _full(decode(dp, dc, dtok)))
    shapes["decode"] = {"layers": cfg.n_layers, "batch": B,
                        "max_len": max_len, "lengths": lengths}
    del dp, dc, cache
    # train: the plain step on a copy of the parameters, the DTensor step
    # on the parameters themselves, wrapped
    if train_layers != dec_layers:
        del params
        _free(dev)
        cfg = _family_config(sz, arch, train_layers)
        model = model_for(cfg)
        rules = logical_rules_for(cfg, mesh)
        params = model.init_params(cfg, 24, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (tb, ts), generator=gen,
                          device=dev, dtype=torch.int32)
    labels = torch.roll(batch, -1, dims=1)
    tcfg = TrainConfig(microbatches=1, remat=True,
                       optimizer=AdamWConfig(lr=3e-4))
    step = make_train_step(cfg, tcfg)

    def train(p, b, lb):
        p, _, metrics = step(p, adamw.init(tcfg.optimizer, p), b, lb)
        return p, metrics["loss"]

    runs["train_plain"] = counted(lambda: train(clone(params), batch, labels))
    _free(dev)
    dp = _wrapped(params, param_shardings(params, mesh))
    db, dl = (_wrapped({"t": t}, {"t": token_sharding(mesh)})["t"]
              for t in (batch, labels))
    with logical_rules(mesh, rules):
        runs["train_dtensor"] = counted(
            lambda: tuple(map(_full, train(dp, db, dl))))
    shapes["train"] = {"layers": cfg.n_layers, "batch": tb, "seq": ts,
                       "microbatches": 1, "remat": True}
    del dp, params
    _free(dev)
    return {"runs": runs, "shapes": shapes, "rules": rules}


def phase_dist_families(dev, sz: Sizes, table, archs=DIST_PARENT,
                        phase: str = "dist_families"):
    """A3c on the card: each of ``archs`` runs a decode step and a train
    step with DTensor parameters on a (1 data x 1 model) DeviceMesh over a
    one-rank group (NCCL on the card), under its logical rules, against
    the same steps on plain parameters (``Sizes.dist_family_*``).  Counters
    are zeroed just before each run and read just after: the launches must
    be equal, and non-zero for every kernel the family's plain step
    launches on the card (``DIST_FAMILY_KERNELS``).  Logits, every cache
    leaf, the loss and the updated parameters of the two runs are held to
    the bf16 tolerance, and whether their bits are equal is reported.
    Launches are credited to the path ``dist_<arch>``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import kernels

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"

    def counted(fn):
        sync(dev)
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        out = fn()
        sync(dev)
        counts = {k: v for k, v in _launches().items() if v}
        return out, counts, time.perf_counter() - t0

    backend = "nccl" if on_card else "gloo"
    dist.init_process_group(backend, rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        mesh = init_device_mesh(dev.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        families = {}
        for arch in archs:
            t0 = time.perf_counter()
            out = _dist_family(dev, sz, arch, mesh, counted)
            runs = out["runs"]
            want = dict(zip(("decode", "train"), DIST_FAMILY_KERNELS[arch]))
            for path, names in want.items():
                plain, dt = runs[f"{path}_plain"][1], \
                    runs[f"{path}_dtensor"][1]
                require(plain == dt, f"{phase} {arch} {path}: launches "
                        f"{plain} plain, {dt} under DTensor")
                require(not on_card or all(dt.get(n, 0) > 0 for n in names),
                        f"{phase} {arch} {path}: no launch of {names}: {dt}")
            errs, bits = {}, {}
            errs["decode"], bits["decode"] = _tree_diff(
                runs["decode_dtensor"][0], runs["decode_plain"][0],
                f"{phase} {arch} decode")
            (p_d, loss_d), (p_p, loss_p) = runs["train_dtensor"][0], \
                runs["train_plain"][0]
            require(math.isfinite(float(loss_p)),
                    f"{phase} {arch}: loss not finite")
            errs["loss"] = abs(float(loss_d) - float(loss_p))
            require(errs["loss"] <= TOL["bfloat16"] * (1 + abs(float(loss_p))),
                    f"{phase} {arch}: loss {float(loss_d)} vs "
                    f"{float(loss_p)}")
            bits["loss"] = bool(torch.equal(loss_d, loss_p))
            errs["params"], bits["params"] = _tree_diff(
                p_d, p_p, f"{phase} {arch} params")
            names = sorted(set(want["decode"]) | set(want["train"]))
            _add_launches(table, f"dist_{arch}", {
                n: runs["decode_dtensor"][1].get(n, 0)
                + runs["train_dtensor"][1].get(n, 0) for n in names}, names)
            families[arch] = {
                **out["shapes"], "rules": {k: str(v) for k, v in
                                           out["rules"].items()},
                "launches": {k: v[1] for k, v in runs.items()},
                "seconds": {k: v[2] for k, v in runs.items()},
                "max_abs_err": errs, "bits_equal": bits,
                "family_seconds": time.perf_counter() - t0}
            del out, runs, p_d, p_p
            _free(dev)
    finally:
        dist.destroy_process_group()
    emit(phase, mesh={"data": 1, "model": 1}, backend=backend,
         families=families, tolerance=TOL["bfloat16"],
         phase_seconds=time.perf_counter() - t_phase)


def phase_dist_families_side(dev, sz: Sizes, table):
    """``phase_dist_families`` over the side process's share."""
    phase_dist_families(dev, sz, table, DIST_SIDE, "dist_families_side")


# --------------------------------------------------------------- serve phases
def _prompts(lengths, vocab: int):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n) for n in lengths]


def _launches() -> dict:
    """Launches by counter: each binding's (``kernels.launch_counts``) and
    each route's that shares one of them (``kernels.route_launch_counts``:
    ``flash_decode``, also counted under ``flash_attention``)."""
    from repro_torch import kernels
    return {**kernels.launch_counts(), **kernels.route_launch_counts()}


def _add_launches(table, path: str, counts: dict, names) -> None:
    """Credit ``path``'s launches of ``names`` to their rows: ``launches``
    is the sum over the paths that launch the kernel."""
    for row in table:
        if row["name"] in names:
            by = row.setdefault("launches_by_path", {})
            by[path] = counts[row["name"]]
            row["launches"] = sum(by.values())


def _serve(dev, sz: Sizes, cfg, params, pool_frames, prompts=None,
           max_len=None, max_new=None):
    from repro_torch.api import FaultPolicy, Strategy
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(
        cfg, params, max_batch=sz.max_batch,
        max_len=max_len or sz.pages_per_seq * cfg.kv_page_tokens,
        pool_frames=pool_frames,
        policy=FaultPolicy(strategy=Strategy.TOUCH_AHEAD, lookahead=4),
        device=dev)
    reqs = [eng.submit(p, max_new_tokens=max_new or sz.max_new)
            for p in _prompts(prompts or sz.prompts, cfg.vocab_size)]
    sync(dev)
    t0 = time.perf_counter()
    eng.run_until_done()
    sync(dev)
    return eng, reqs, time.perf_counter() - t0


def phase_spill_parity(dev, sz: Sizes, pcfg, params):
    eng_a, reqs_a, _ = _serve(dev, sz, pcfg, params, None)
    eng_b, reqs_b, _ = _serve(dev, sz, pcfg, params, sz.pool_frames)
    require(eng_a.stats.spill_events == 0, "exact-fit pool spilled")
    require(eng_b.stats.spill_events > 0 and eng_b.stats.fault_page_ins > 0,
            "undersized pool did not spill")
    same = [a.generated == b.generated for a, b in zip(reqs_a, reqs_b)]
    require(all(same) and all(r.done for r in reqs_b),
            f"tokens differ between exact-fit and undersized pool: {same}")
    emit("spill_parity", layers=pcfg.n_layers, requests=len(reqs_b),
         tokens_identical=True, spill_events=eng_b.stats.spill_events,
         fault_page_ins=eng_b.stats.fault_page_ins)


def phase_serve(dev, sz: Sizes, cfg, table):
    import torch
    from repro_torch import kernels
    from repro_torch.models import decoder
    from repro_torch.tree import tree_leaves

    if sz.serve_layers:
        cfg = dataclasses.replace(cfg, n_layers=sz.serve_layers)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, 0, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))

    kernels.reset_launch_counts()
    eng, reqs, wall = _serve(dev, sz, cfg, params, sz.pool_frames)
    counts = kernels.launch_counts()

    st = eng.stats
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    step_calls = prompt_tokens + st.decode_steps    # decode_step invocations
    require(all(r.done and len(r.generated) == sz.max_new for r in reqs),
            "a request did not finish")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
            "token id out of range")
    require(st.tokens_generated == len(reqs) * sz.max_new, "token count")
    require(st.spill_events > 0 and st.fault_page_ins > 0,
            f"no spill / fault-back-in: {st}")
    if dev.type == "cuda":
        require(counts["paged_attention"] == cfg.n_layers * step_calls,
                f"paged_attention launches {counts['paged_attention']} != "
                f"{cfg.n_layers} layers x {step_calls} decode_step calls")
        require(counts["page_gather"] > 0 and counts["page_scatter"] > 0
                and counts["page_gather"] == counts["page_scatter"],
                f"page gather/scatter launches: {counts}")
    _add_launches(table, "serve", counts,
                  ("paged_attention", "page_gather", "page_scatter"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    emit("serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=n_params, dtype=cfg.dtype, init_seconds=round(init_s, 3),
         max_batch=sz.max_batch, max_len=sz.pages_per_seq * cfg.kv_page_tokens,
         page_tokens=cfg.kv_page_tokens, pool_frames=sz.pool_frames,
         requests_done=sum(r.done for r in reqs),
         prompt_lengths=[len(r.prompt) for r in reqs],
         tokens_generated=st.tokens_generated, decode_steps=st.decode_steps,
         decode_step_calls=step_calls, wall_seconds=wall,
         generated_tokens_per_s=st.tokens_generated / wall,
         processed_tokens_per_s=(prompt_tokens + st.tokens_generated) / wall,
         engine_stats=dataclasses.asdict(st),
         kv_stats={k: v for k, v in dataclasses.asdict(eng.kv.stats).items()
                   if v},
         max_memory_allocated=peak, launches=counts,
         first_tokens=[r.generated[:4] for r in reqs])
    return params, cfg


# -------------------------------------------------------- phase: serve_danube
def phase_serve_danube(dev, sz: Sizes, table):
    """``ServingEngine`` on H2O-Danube-1.8B at published width and depth (24
    layers, d_model 2560, 32/8 heads of head_dim 80: paged attention's 128
    instance with the columns past 80 zero-filled), random weights from a
    seed, the ``serve`` phase's settings, requests and undersized pool.

    The decoder gives a sliding-window config a ring buffer
    (``decoder.uses_ring``, as the reference does), which never reaches
    ``paged_attention``.  The engine's context (``max_len`` 1,024) is
    inside Danube's 4,096-token window, where the window masks nothing, so
    the phase serves the model with the window off, which decodes through
    the paged pools.  That config runs the kernel path first, counters
    zeroed just before and read just after (``paged_attention`` launches =
    24 x decode_step calls; page copies; spills and fault page-ins), then
    the plain path (``paged_attention_ref``) on the card: identical greedy
    tokens.  Last the published config on its own ring path (plain torch,
    no kernel) at its first ``danube_ring_layers`` layers, which must
    finish every request: the two layouts place a batch's new token at the
    first sequence's offset in their own ways (the reference's lock-step
    write), so their tokens are not compared."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decoder
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _arch_config(sz, sz.danube_arch)
    max_len = sz.pages_per_seq * cfg.kv_page_tokens
    require(decoder.uses_ring(cfg) and max_len <= cfg.sliding_window,
            f"{cfg.name}: window {cfg.sliding_window} at context {max_len}")
    paged = dataclasses.replace(cfg, sliding_window=0)
    _free(dev)
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, 0, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))

    kernels.reset_launch_counts()
    eng, reqs, wall = _serve(dev, sz, paged, params, sz.pool_frames)
    counts = kernels.launch_counts()
    st = eng.stats
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    step_calls = prompt_tokens + st.decode_steps
    require(all(r.done and len(r.generated) == sz.max_new for r in reqs),
            "a request did not finish")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
            "token id out of range")
    require(st.spill_events > 0 and st.fault_page_ins > 0,
            f"no spill / fault-back-in: {st}")
    if dev.type == "cuda":
        require(counts["paged_attention"] == cfg.n_layers * step_calls,
                f"paged_attention launches {counts['paged_attention']} != "
                f"{cfg.n_layers} layers x {step_calls} decode_step calls")
        require(counts["page_gather"] > 0
                and counts["page_gather"] == counts["page_scatter"],
                f"page gather/scatter launches: {counts}")
    _add_launches(table, "serve_danube", counts,
                  ("paged_attention", "page_gather", "page_scatter"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stats = dataclasses.asdict(st)
    del eng

    kernel_fn = attn_mod.paged_attention
    attn_mod.paged_attention = paged_attention_ref      # plain path, on card
    try:
        _, reqs_p, wall_p = _serve(dev, sz, paged, params, sz.pool_frames)
    finally:
        attn_mod.paged_attention = kernel_fn
    same = [a.generated == b.generated for a, b in zip(reqs, reqs_p)]
    require(all(same), f"greedy tokens differ between the kernel and the "
            f"plain path: {same}")
    rcfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers,
                                                 sz.danube_ring_layers))
    rparams = dict(params, dense_layers=tree_map(
        lambda t: t[:rcfg.n_layers], params["dense_layers"]))
    ring_eng, reqs_r, wall_r = _serve(dev, sz, rcfg, rparams, sz.pool_frames)
    del rparams
    require(all(r.done and len(r.generated) == sz.max_new for r in reqs_r),
            "a request did not finish on the ring path")
    emit("serve_danube", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.head_dim, window=cfg.sliding_window,
         window_in_the_paged_runs="off (masks nothing at this context)",
         params=n_params, dtype=cfg.dtype, init_seconds=init_s,
         max_batch=sz.max_batch, max_len=max_len,
         page_tokens=cfg.kv_page_tokens, pool_frames=sz.pool_frames,
         prompt_lengths=[len(r.prompt) for r in reqs],
         requests_done=sum(r.done for r in reqs),
         tokens_generated=st.tokens_generated, decode_steps=st.decode_steps,
         decode_step_calls=step_calls, wall_seconds=wall,
         plain_path_wall_seconds=wall_p, ring_path_layers=rcfg.n_layers,
         ring_path_wall_seconds=wall_r,
         generated_tokens_per_s=st.tokens_generated / wall,
         processed_tokens_per_s=(prompt_tokens + st.tokens_generated) / wall,
         tokens_identical_kernel_vs_plain=True,
         ring_path_spill_events=ring_eng.stats.spill_events,
         spill_events=st.spill_events, fault_page_ins=st.fault_page_ins,
         engine_stats=stats, max_memory_allocated=peak,
         launches=counts, first_tokens=[r.generated[:4] for r in reqs])
    del params, ring_eng
    _free(dev)


# ------------------------------------------------------- phase: serve_hybrid
def _first_layers(params, cfg, n_layers: int):
    """The first ``n_layers`` Mamba layers of a hybrid model and the shared
    block, as a config and params of that depth (views, no copy): whole
    groups, then the next layers of the following group as the tail."""
    from repro_torch.models.hybrid import group_layout
    from repro_torch.tree import tree_map
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    G, k, tail = group_layout(cut)
    out = dict(params, groups=tree_map(lambda t: t[:G], params["groups"]))
    out.pop("tail", None)
    if tail:
        out["tail"] = tree_map(lambda t: t[G, :tail], params["groups"])
    return cut, out


def _nbytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _step_bytes(dev, sz: Sizes, cfg, eng, params, iters: int,
                pinned: str = "ssm", w_bytes=None) -> dict:
    """What one decode step of the engine moves for one sequence, paged
    against pinned: its KV pages (``k_pool`` / ``v_pool``, ``page_scatter``
    in and ``page_gather`` out), its pinned state (every other leaf but
    ``lengths`` and the page table, batch on axis 1, strided copies in
    and out: the hybrid's Mamba state ``ssm`` / ``conv``, the
    encoder-decoder's cross K/V), and the weights a batch step reads once
    (``w_bytes``; by default all but the embedding); bytes from the
    shapes, device ms of each copy as the engine makes it (``time_ms``),
    the weights' bytes over the HBM rate."""
    from repro_torch.kernels.page_pack.ops import gather_pages, scatter_pages
    from repro_torch.tree import tree_leaves, tree_names
    seq = eng.model.init_decode_cache(cfg, 1, eng.max_len, device=dev)
    full = dict(zip(tree_names(eng.cache), tree_leaves(eng.cache)))
    part = dict(zip(tree_names(seq), tree_leaves(seq)))
    pools = [n for n in full if "pool" in n]
    states = [n for n in full if "pool" not in n and "table" not in n
              and n != "lengths"]
    slot = min(1, sz.max_batch - 1)

    def kv(direction):
        for n in pools:
            L, P = full[n].shape[:2]
            per = part[n].shape[1]
            big = full[n].view((L * P,) + full[n].shape[2:])
            small = part[n].view((L * per,) + part[n].shape[2:])
            rows = eng._rows(L, P, per, slot)
            if direction == "in":
                scatter_pages(big, rows, small)
            else:
                gather_pages(big, rows, out=small)

    def state(direction):
        for n in states:
            if direction == "in":
                full[n][:, slot] = part[n][:, 0]
            else:
                part[n][:, 0] = full[n][:, slot]

    kv_bytes = sum(part[n].numel() * part[n].element_size() for n in pools)
    st_bytes = sum(part[n].numel() * part[n].element_size() for n in states)
    if w_bytes is None:
        w_bytes = _nbytes(params) - _nbytes(params["embed"])
    return {
        "per_sequence_each_way": {
            "kv_pages_bytes": kv_bytes, f"{pinned}_state_bytes": st_bytes,
            "kv_copy_in_ms": time_ms(dev, [lambda: kv("in")], iters),
            "kv_copy_out_ms": time_ms(dev, [lambda: kv("out")], iters),
            f"{pinned}_copy_in_ms": time_ms(dev, [lambda: state("in")],
                                            iters),
            f"{pinned}_copy_out_ms": time_ms(dev, [lambda: state("out")],
                                             iters)},
        "batch_cache": {"kv_pools_bytes": sum(
            full[n].numel() * full[n].element_size() for n in pools),
            f"{pinned}_state_bytes": sum(
                full[n].numel() * full[n].element_size() for n in states),
            "max_batch": sz.max_batch},
        "weights_read_per_step_bytes": w_bytes,
        "weights_floor_ms": w_bytes / HBM_BYTES_PER_S * 1e3,
        "kv_pages_bytes_per_step_in_and_out_at_max_batch":
            2 * sz.max_batch * kv_bytes,
        f"{pinned}_state_bytes_per_step_in_and_out_at_max_batch":
            2 * sz.max_batch * st_bytes}


def _checked_paged_attention(record: dict):
    """``paged_attention`` that also runs ``paged_attention_ref`` on the
    same inputs and records the largest error and the calls beyond the
    bf16 tolerance (atol = rtol = 2e-2); it returns the kernel's output."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    def attend(q, kp, vp, pt, ln, window=0):
        out = paged_attention(q, kp, vp, pt, ln, window=window)
        ref = paged_attention_ref(q, kp, vp, pt, ln, window=window)
        tol = TOL[str(q.dtype).split(".")[-1]]
        diff = (out.float() - ref.float()).abs()
        record["calls"] += 1
        record["beyond_tolerance"] += int(not bool(
            (diff <= tol + tol * ref.float().abs()).all()))
        record["max_abs_err"] = max(record["max_abs_err"],
                                    float(diff.max()))
        return out

    return attend


def phase_serve_hybrid(dev, sz: Sizes, table):
    """``ServingEngine`` on Zamba2-7B at published width and depth (81
    Mamba2 layers in 13 groups of 6 and a 3-layer tail, one shared
    attention block applied after each group: head_dim 112 on paged
    attention's 128 instance), random weights from a seed, greedy, the
    ``serve`` phase's settings, requests and undersized pool; the engine
    run at ``hybrid_serve_layers`` (2 groups and the tail: at 81 layers
    it took 121.8 s of a run near its time limit), counters zeroed just
    before and read just after (``paged_attention`` launches = sites x
    decode_step calls; page copies of the sites' KV rows; spills and fault
    page-ins); the step's bytes and a batch-1 step at full depth: what a
    step moves per sequence (KV pages against the pinned Mamba state
    against the weights) and a batch-1 decode step profiled.  The
    comparison with the plain path is ``phase_serve_hybrid_plain``."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import hybrid
    from repro_torch.models.mamba import mamba_dims
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.tree import tree_leaves

    cfg = _arch_config(sz, sz.zamba_arch)
    require(cfg.family == "hybrid", cfg.family)
    G, k, tail = hybrid.group_layout(cfg)
    _free(dev)
    t0 = time.perf_counter()
    params = hybrid.init_params(cfg, 0, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))

    scfg, sparams = _first_layers(params, cfg, sz.hybrid_serve_layers)
    G_run = hybrid.group_layout(scfg)[0]
    kernels.reset_launch_counts()
    eng, reqs, wall = _serve(dev, sz, scfg, sparams, sz.pool_frames)
    counts = kernels.launch_counts()
    st = eng.stats
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    step_calls = prompt_tokens + st.decode_steps
    require(all(r.done and len(r.generated) == sz.max_new for r in reqs),
            "a request did not finish")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
            "token id out of range")
    require(st.spill_events > 0 and st.fault_page_ins > 0,
            f"no spill / fault-back-in: {st}")
    if dev.type == "cuda":
        require(counts["paged_attention"] == G_run * step_calls,
                f"paged_attention launches {counts['paged_attention']} != "
                f"{G_run} sites x {step_calls} decode_step calls")
        require(counts["page_gather"] > 0
                and counts["page_gather"] == counts["page_scatter"],
                f"page gather/scatter launches: {counts}")
        require(counts["flash_attention"] == 0, f"flash on decode: {counts}")
    _add_launches(table, "serve_hybrid", counts,
                  ("paged_attention", "page_gather", "page_scatter"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stats = dataclasses.asdict(st)
    # what a step moves, at full depth: an engine over the published
    # model's cache, not run
    moved = _step_bytes(dev, sz, cfg, ServingEngine(
        cfg, params, max_batch=sz.max_batch,
        max_len=sz.pages_per_seq * cfg.kv_page_tokens,
        pool_frames=sz.pool_frames, device=dev), params, 10)
    del eng

    profile = _decode_profile(dev, sz, cfg, params, 3)
    emit("serve_hybrid", arch=cfg.name, layers=cfg.n_layers,
         engine_run_layers=scfg.n_layers, engine_run_sites=G_run, groups=G,
         group_size=k, tail=tail, d_model=cfg.d_model, heads=cfg.n_heads,
         kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
         ssm_state=cfg.ssm_state, ssm_heads=mamba_dims(cfg)[1],
         vocab=cfg.vocab_size, params=n_params,
         param_bytes=_nbytes(params), dtype=cfg.dtype, init_seconds=init_s,
         max_batch=sz.max_batch, max_len=sz.pages_per_seq * cfg.kv_page_tokens,
         page_tokens=cfg.kv_page_tokens, pool_frames=sz.pool_frames,
         prompt_lengths=[len(r.prompt) for r in reqs],
         requests_done=sum(r.done for r in reqs),
         tokens_generated=st.tokens_generated, decode_steps=st.decode_steps,
         decode_step_calls=step_calls, wall_seconds=wall,
         generated_tokens_per_s=st.tokens_generated / wall,
         processed_tokens_per_s=(prompt_tokens + st.tokens_generated) / wall,
         spill_events=st.spill_events, fault_page_ins=st.fault_page_ins,
         engine_stats=stats, max_memory_allocated=peak, launches=counts,
         plain_comparison="phase serve_hybrid_plain",
         bytes_moved_per_step=moved, batch1_decode_step=profile,
         first_tokens=[r.generated[:4] for r in reqs])
    del params
    _free(dev)


def phase_serve_hybrid_plain(dev, sz: Sizes, table):
    """``serve_hybrid``'s comparison with the plain path
    (``paged_attention_ref``, on the card): the same weights (the same
    seed) at the model's first ``hybrid_plain_layers`` layers, the
    ``serve`` phase's requests and undersized pool.  The engine is
    host-bound (81 Mamba layers of small ops a step), and a path at full
    depth takes minutes.  In bf16 every ``paged_attention`` call of the
    kernel path is held against the plain version on its own inputs (the
    bf16 tolerance); in float32 the kernel path and the plain path must
    give identical greedy tokens.  bf16 tokens are not compared: the
    model's bf16 logits tie (a top-2 gap of 0) at some steps, where any
    rounding picks either token.  Times no kernel: it runs in the side
    process (``SIDE``); ``table`` is unused."""
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import hybrid
    from repro_torch.tree import tree_map

    cfg = _arch_config(sz, sz.zamba_arch)
    _free(dev)
    params = hybrid.init_params(cfg, 0, device=dev)
    ccfg, cparams = _first_layers(params, cfg, sz.hybrid_plain_layers)
    checked = {"calls": 0, "beyond_tolerance": 0, "max_abs_err": 0.0}
    kernel_fn = attn_mod.paged_attention
    attn_mod.paged_attention = _checked_paged_attention(checked)
    try:
        _, reqs_c, wall_c = _serve(dev, sz, ccfg, cparams, sz.pool_frames)
    finally:
        attn_mod.paged_attention = kernel_fn
    require(checked["beyond_tolerance"] == 0 and checked["calls"] > 0,
            f"paged_attention against its plain version on the bf16 "
            f"serving inputs: {checked}")
    fcfg = dataclasses.replace(ccfg, dtype="float32")
    fparams = tree_map(lambda t: t.float(), cparams)
    del params, cparams
    _, reqs_f, wall_f = _serve(dev, sz, fcfg, fparams, sz.pool_frames)
    attn_mod.paged_attention = paged_attention_ref      # plain path, on card
    try:
        _, reqs_p, wall_p = _serve(dev, sz, fcfg, fparams, sz.pool_frames)
    finally:
        attn_mod.paged_attention = kernel_fn
    same = [a.generated == b.generated for a, b in zip(reqs_f, reqs_p)]
    require(all(same), f"float32 greedy tokens differ between the kernel "
            f"and the plain path at {fcfg.n_layers} layers: {same}")
    bf16_same = [a.generated == b.generated for a, b in zip(reqs_c, reqs_f)]
    del fparams
    emit("serve_hybrid_plain", arch=cfg.name, layers=ccfg.n_layers,
         sites=hybrid.group_layout(ccfg)[0],
         bfloat16_kernel_calls_against_plain=checked,
         bfloat16_checked_wall_seconds=wall_c,
         float32_tokens_identical_kernel_vs_plain=True,
         float32_kernel_wall_seconds=wall_f,
         float32_plain_wall_seconds=wall_p,
         bfloat16_tokens_equal_float32_tokens=bf16_same)
    _free(dev)


# ------------------------------------------------------- phase: serve_encdec
def _checked_flash(record: dict, kernel_fn):
    """``flash_attention`` through ``kernel_fn`` that also runs
    ``flash_attention_ref`` on the same inputs and records, per call, the
    largest absolute error and the largest relative L2 error of a row
    (one position of one head, ``_row_rel_err``), counting the calls whose
    row error is beyond the tolerance of the inputs' dtype (the
    ``kernels`` phase's bf16 criterion); it returns the kernel's output."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    def attend(q, k, v, *, causal=True, window=0, **kw):
        out = kernel_fn(q, k, v, causal=causal, window=window, **kw)
        ref = flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)
        rel = _row_rel_err(out, ref)
        record["calls"] += 1
        record["beyond_tolerance"] += int(
            rel > TOL[str(q.dtype).split(".")[-1]])
        record["max_abs_err"] = max(record["max_abs_err"], max_err(out, ref))
        record["max_row_rel_err"] = max(record["max_row_rel_err"], rel)
        record["shapes"].add((tuple(q.shape), tuple(k.shape)))
        return out

    return attend


def _encoded_decode(dev, sz: Sizes, cfg, params, frames, prompt) -> tuple:
    """Greedy decode over a batch cache whose pinned cross K/V are
    ``cross_kv(params, cfg, encode(params, cfg, frames))``: ``prompt``
    (B, P) teacher-forced, then ``whisper_max_new`` greedy tokens.
    Returns (tokens per sequence, wall s)."""
    import torch
    from repro_torch.models import encdec
    sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        ck, cv = encdec.cross_kv(params, cfg, encdec.encode(params, cfg,
                                                            frames))
    B = frames.shape[0]
    cache = encdec.init_decode_cache(cfg, B, sz.whisper_max_len, device=dev)
    cache["cross_k"].copy_(ck)
    cache["cross_v"].copy_(cv)
    del ck, cv
    for t in range(prompt.shape[1]):
        logits, cache = encdec.decode_step(params, cfg, cache,
                                           prompt[:, t:t + 1])
    out = []
    for _ in range(sz.whisper_max_new):
        nxt = logits[:, 0].argmax(-1, keepdim=True)
        out.append(nxt)
        logits, cache = encdec.decode_step(params, cfg, cache, nxt)
    tokens = torch.cat(out, 1).tolist()
    sync(dev)
    return tokens, time.perf_counter() - t0


def phase_serve_encdec(dev, sz: Sizes, table):
    """``ServingEngine`` on Whisper-medium at published width and depth
    (24 encoder and 24 decoder layers, d 1,024, 16 heads of 64, bf16),
    random weights from a seed, greedy, ``max_batch`` 4, ``max_len`` 448
    (2 pages of 256 a sequence), an undersized pool of 5 frames against
    8, the requests of ``whisper_prompts`` with ``whisper_max_new`` new
    tokens each; counters zeroed just before and read just after: as in
    the reference the engine never encodes, so it decodes over the zero
    cross K/V of ``init_decode_cache`` — ``paged_attention`` (decoder
    self-attention) and ``flash_attention`` (cross-attention, Sq = 1 over
    1,500 frames) each 24 x decode_step calls, every flash call on the
    decode kernel (``flash_decode``).  Then what a step moves per
    sequence, paged self-attention KV against the pinned cross K/V, and a
    batch-1 decode step profiled: ``flash_decode_kernel`` must be among
    its kernels, and its paged-attention call gets its bound.

    Then the encoded decode: a batch of ``max_batch`` random frame
    sequences, ``encode`` and ``cross_kv`` into the cache, 4 prompt tokens
    and 16 greedy steps (:func:`_encoded_decode`).  In float32 the kernel
    path and the plain path on the card (``flash_attention_xla`` for the
    encoder and the cross-attention, ``paged_attention_ref`` for the
    decoder's) give the same greedy tokens.  In bf16 every flash call of
    the path (the encoder's and every cross-attention call) is held
    against ``flash_attention_ref`` on its own inputs; bf16 tokens are not
    compared (random weights' bf16 logits tie)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import encdec
    from repro_torch.models.attention_ops import flash_attention_xla
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _arch_config(sz, sz.whisper_arch)
    require(cfg.family == "encdec", cfg.family)
    L = cfg.n_layers
    _free(dev)
    t0 = time.perf_counter()
    params = encdec.init_params(cfg, 0, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    param_bytes = _nbytes(params)

    kernels.reset_launch_counts()
    eng, reqs, wall = _serve(dev, sz, cfg, params, sz.whisper_pool_frames,
                             prompts=sz.whisper_prompts,
                             max_len=sz.whisper_max_len,
                             max_new=sz.whisper_max_new)
    counts = _launches()
    st = eng.stats
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    step_calls = prompt_tokens + st.decode_steps
    require(all(r.done and len(r.generated) == sz.whisper_max_new
                for r in reqs), "a request did not finish")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
            "token id out of range")
    if dev.type == "cuda":
        require(counts["paged_attention"] == L * step_calls
                and counts["flash_attention"] == L * step_calls
                and counts["flash_attention_bwd"] == 0,
                f"launches {counts} != {L} layers x {step_calls} "
                f"decode_step calls (paged_attention, flash_attention)")
        require(counts["flash_decode"] == counts["flash_attention"],
                f"cross-attention at Sq = 1 off the decode kernel: {counts}")
        require(counts["page_gather"] > 0
                and counts["page_gather"] == counts["page_scatter"],
                f"page gather/scatter launches: {counts}")
    _add_launches(table, "serve_encdec", counts,
                  ("paged_attention", "page_gather", "page_scatter",
                   "flash_attention", "flash_decode"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stats = dataclasses.asdict(st)
    # a decode step reads the decoder's weights and the tied embedding
    # (the head), not the encoder's
    w_bytes = _nbytes(params) - _nbytes(params["enc_layers"])
    moved = _step_bytes(dev, sz, cfg, eng, params, 10, pinned="cross_kv",
                        w_bytes=w_bytes)
    del eng
    profile = _decode_profile(dev, sz, cfg, params, 3,
                              max_len=sz.whisper_max_len)
    if dev.type == "cuda":
        named = [k["name"] for k in profile["port_kernels"]]
        require(any("flash_decode_kernel" in n for n in named),
                f"no flash_decode_kernel in the batch-1 step's profile: "
                f"{named}")
    # the batch-1 step's paged self-attention call: its bound (K and V of
    # the context read once, q and the output once; bf16)
    ctx = profile["context"]
    profile["paged_attention_bound_ms"] = (
        2 * (2 * ctx * cfg.n_kv_heads * cfg.head_dim
             + 2 * cfg.n_heads * cfg.head_dim)
        + 4 * (-(-sz.whisper_max_len // cfg.kv_page_tokens) + 1)) \
        / HBM_BYTES_PER_S * 1e3

    # the encoded decode
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    B = sz.max_batch
    frames = torch.randn((B, cfg.max_source_positions, cfg.d_model),
                         generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (B, sz.whisper_decode_prompt),
                           generator=gen, device=dev)
    kernel_fns = (attn_mod.flash_attention, attn_mod.paged_attention)

    def restore():
        attn_mod.flash_attention, attn_mod.paged_attention = kernel_fns

    checked = {n: {"calls": 0, "beyond_tolerance": 0, "max_abs_err": 0.0,
                   "max_row_rel_err": 0.0, "shapes": set()}
               for n in ("encoder", "cross")}
    # every flash call goes through attention's binding (cross-attention
    # through its region, attention._flash_dist): Sq != Sk is the cross
    by_kind = {n: _checked_flash(rec, kernel_fns[0])
               for n, rec in checked.items()}
    attn_mod.flash_attention = lambda q, k, v, **kw: by_kind[
        "cross" if q.shape[1] != k.shape[1] else "encoder"](q, k, v, **kw)
    try:
        tok_bf16, wall_bf16 = _encoded_decode(
            dev, sz, cfg, params, frames.to(params["embed"].dtype), prompt)
    finally:
        restore()
    for n, rec in checked.items():
        require(rec["calls"] > 0 and rec["beyond_tolerance"] == 0,
                f"{n} flash calls against the plain version on the bf16 "
                f"encoded decode: {rec}")
        rec["shapes"] = sorted(rec["shapes"])
    require(checked["cross"]["calls"] == L * (sz.whisper_decode_prompt
                                              + sz.whisper_max_new),
            f"cross-attention calls {checked['cross']['calls']}")
    fcfg = dataclasses.replace(cfg, dtype="float32")
    fparams = tree_map(lambda t: t.float(), params)
    del params
    _free(dev)
    kernels.reset_launch_counts()
    tok_f, wall_f = _encoded_decode(dev, sz, fcfg, fparams, frames, prompt)
    f32_counts = _launches()
    attn_mod.flash_attention = flash_attention_xla
    attn_mod.paged_attention = paged_attention_ref
    try:
        tok_p, wall_p = _encoded_decode(dev, sz, fcfg, fparams, frames,
                                        prompt)
    finally:
        restore()
    require(tok_f == tok_p, f"float32 greedy tokens differ between the "
            f"kernel and the plain path: {tok_f} vs {tok_p}")
    del fparams
    _free(dev)
    cross_b = moved["per_sequence_each_way"]["cross_kv_state_bytes"]
    kv_b = moved["per_sequence_each_way"]["kv_pages_bytes"]
    emit("serve_encdec", arch=cfg.name, layers=L,
         encoder_layers=cfg.n_enc_layers, d_model=cfg.d_model,
         heads=cfg.n_heads, head_dim=cfg.head_dim,
         source_frames=cfg.max_source_positions, vocab=cfg.vocab_size,
         params=n_params, param_bytes=param_bytes, dtype=cfg.dtype,
         init_seconds=init_s, max_batch=sz.max_batch,
         max_len=sz.whisper_max_len, page_tokens=cfg.kv_page_tokens,
         pool_frames=sz.whisper_pool_frames,
         prompt_lengths=[len(r.prompt) for r in reqs],
         requests_done=sum(r.done for r in reqs),
         tokens_generated=st.tokens_generated, decode_steps=st.decode_steps,
         decode_step_calls=step_calls, wall_seconds=wall,
         generated_tokens_per_s=st.tokens_generated / wall,
         processed_tokens_per_s=(prompt_tokens + st.tokens_generated) / wall,
         spill_events=st.spill_events, fault_page_ins=st.fault_page_ins,
         engine_stats=stats, max_memory_allocated=peak, launches=counts,
         bytes_moved_per_step=moved,
         paged_self_kv_bytes_per_sequence=kv_b,
         pinned_cross_kv_bytes_per_sequence=cross_b,
         pinned_over_paged=cross_b / kv_b,
         batch1_decode_step=profile,
         encoded_decode={
             "batch": B, "prompt_tokens": sz.whisper_decode_prompt,
             "greedy_steps": sz.whisper_max_new,
             "bfloat16_flash_calls_against_plain": checked,
             "bfloat16_wall_seconds": wall_bf16,
             "float32_tokens_identical_kernel_vs_plain": True,
             "float32_kernel_launches": f32_counts,
             "float32_kernel_wall_seconds": wall_f,
             "float32_plain_wall_seconds": wall_p,
             "bfloat16_tokens_equal_float32_tokens": [
                 a == b for a, b in zip(tok_bf16, tok_f)],
             "first_tokens_float32": [t[:4] for t in tok_f]},
         first_tokens=[r.generated[:4] for r in reqs])


# ------------------------------------------------------- phase: serve_mla_moe
def _arch_config(sz: Sizes, arch: str, **overrides):
    """``arch`` at published width (or reduced with ``full_width=False``,
    for a rehearsal on the CPU) with ``overrides``."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced
    cfg = get_config(arch)
    if not sz.full_width:
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, **overrides)


def _free(dev) -> None:
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _moe_decode_floor(dev, cfg, params, iters: int) -> dict:
    """The dropless MoE layer of one batch-1 decode step alone: device ms
    against the bytes of all experts' weights (the reference's dense
    dispatch runs the expert einsums over every expert)."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.tree import tree_leaves
    lp = {k: v[0] for k, v in params["moe_layers"]["moe"].items()
          if k != "shared"}
    if "shared" in params["moe_layers"]["moe"]:
        lp["shared"] = {k: v[0] for k, v in
                        params["moe_layers"]["moe"]["shared"].items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    x = _rand(gen, (1, 1, cfg.d_model), params["embed"].dtype, dev)
    with torch.no_grad():
        ms = time_ms(dev, [lambda: moe_mod.apply_moe(lp, cfg, x,
                                                     dropless=True)], iters)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(lp))
    return {"ms": ms, "weight_bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_share": nbytes / HBM_BYTES_PER_S * 1e3 / ms}


def phase_serve_mla_moe(dev, sz: Sizes, table):
    """``ServingEngine`` on DeepSeek-V3 at published width cut to
    ``mla_layers`` (its ``first_k_dense`` dense layers and MoE layers
    after), random weights from a seed, greedy, ``max_batch`` 4, 1024-token
    context, the paged latent pools.  The same requests on an exact-fit
    pool, then (counters zeroed just before, read just after) on an
    undersized pool (spills, fault-back-ins): identical tokens.  Then the
    engine's copies of both latent pools through the kernels against
    ``page_pack/ref.py`` bit for bit, one batch-1 decode step profiled, and
    the MoE layer of that step against its bytes floor."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.page_pack.ops import gather_pages, scatter_pages
    from repro_torch.kernels.page_pack.ref import (page_gather_ref,
                                                   page_scatter_ref)
    from repro_torch.models import decoder
    from repro_torch.tree import tree_leaves

    cfg = _arch_config(sz, sz.mla_arch, n_layers=sz.mla_layers)
    require(cfg.family == "mla_moe" and cfg.first_k_dense < cfg.n_layers,
            f"{cfg.name}: no MoE layer at {cfg.n_layers} layers")
    _free(dev)
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, 0, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)

    eng_a, reqs_a, wall_a = _serve(dev, sz, cfg, params, None,
                                   sz.mla_prompts)
    require(eng_a.stats.spill_events == 0, "exact-fit pool spilled")
    kernels.reset_launch_counts()
    eng, reqs, wall = _serve(dev, sz, cfg, params, sz.mla_pool_frames,
                             sz.mla_prompts)
    counts = kernels.launch_counts()

    st = eng.stats
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    step_calls = prompt_tokens + st.decode_steps
    require(all(r.done and len(r.generated) == sz.max_new for r in reqs),
            "a request did not finish")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
            "token id out of range")
    require(st.spill_events > 0 and st.fault_page_ins > 0,
            f"no spill / fault-back-in: {st}")
    same = [a.generated == b.generated for a, b in zip(reqs_a, reqs)]
    require(all(same), f"tokens differ between exact-fit and undersized "
            f"pool: {same}")
    if dev.type == "cuda":
        # two pools (ckv, krope) copied in and out per sequence and step
        require(counts["page_gather"] > 0
                and counts["page_gather"] == counts["page_scatter"]
                and counts["page_gather"] % 2 == 0,
                f"page gather/scatter launches: {counts}")
        require(counts["paged_attention"] == 0
                and counts["flash_attention"] == 0,
                f"GQA attention kernels on the MLA path: {counts}")
    _add_launches(table, "serve_mla_moe", counts,
                  ("page_gather", "page_scatter"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the engine's copies of both latent pools: kernels against ref.py
    copies = {}
    for name in ("ckv_pool", "krope_pool"):
        full = eng.cache[name]
        L, P = full.shape[:2]
        flat = full.view((L * P,) + tuple(full.shape[2:]))
        gen = torch.Generator(device=dev)
        gen.manual_seed(8)
        for slot in range(sz.max_batch):
            rows = eng._rows(L, P, sz.pages_per_seq, slot)
            require(torch.equal(gather_pages(flat, rows),
                                page_gather_ref(flat, rows)),
                    f"{name}: page_gather of slot {slot} differs from ref")
            blk = _rand(gen, (rows.numel(),) + tuple(flat.shape[1:]),
                        flat.dtype, dev)
            require(torch.equal(scatter_pages(flat.clone(), rows, blk),
                                page_scatter_ref(flat.clone(), rows, blk)),
                    f"{name}: page_scatter of slot {slot} differs from ref")
        copies[name] = {"pool": list(full.shape),
                        "row_bytes": flat[0].numel() * flat.element_size(),
                        "slots_checked": sz.max_batch, "bit_exact": True}
    del eng_a, eng

    profile = _decode_profile(dev, sz, cfg, params, 3)
    moe_floor = _moe_decode_floor(dev, cfg, params, 5)
    step_bytes = param_bytes - params["embed"].numel() \
        * params["embed"].element_size()
    emit("serve_mla_moe", arch=cfg.name, layers=cfg.n_layers,
         first_k_dense=cfg.first_k_dense, d_model=cfg.d_model,
         heads=cfg.n_heads, kv_lora_rank=cfg.kv_lora_rank,
         experts=cfg.n_experts, top_k=cfg.experts_per_token,
         vocab=cfg.vocab_size, params=n_params, param_bytes=param_bytes,
         dtype=cfg.dtype, init_seconds=init_s, max_batch=sz.max_batch,
         max_len=sz.pages_per_seq * cfg.kv_page_tokens,
         page_tokens=cfg.kv_page_tokens, pool_frames=sz.mla_pool_frames,
         prompt_lengths=[len(r.prompt) for r in reqs],
         requests_done=sum(r.done for r in reqs),
         tokens_generated=st.tokens_generated, decode_steps=st.decode_steps,
         decode_step_calls=step_calls, wall_seconds=wall,
         exact_fit_wall_seconds=wall_a,
         generated_tokens_per_s=st.tokens_generated / wall,
         processed_tokens_per_s=(prompt_tokens + st.tokens_generated) / wall,
         tokens_identical_exact_fit_vs_undersized=True,
         spill_events=st.spill_events, fault_page_ins=st.fault_page_ins,
         engine_stats=dataclasses.asdict(st), max_memory_allocated=peak,
         launches=counts, latent_pool_copies=copies,
         decode_step_bytes=step_bytes,
         decode_step_floor_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
         floor_rate="3.35 TB/s, the H100 SXM data sheet",
         batch1_decode_step=profile, moe_layer_batch1=moe_floor,
         first_tokens=[r.generated[:4] for r in reqs])
    del params
    _free(dev)


# -------------------------------------------------------- phase: serve_xlstm
XLSTM_FLIP_OF_MAX = 1e-4      # a token may differ only on a top-2 margin
                              # below this x max|logit| of the loop's step
XLSTM_STATE_BYTES = 23_679_136    # pinned decode state of one sequence


def _xlstm_head(params, cfg, n_mlstm: int):
    """The first ``n_mlstm`` layers of an xLSTM model's opening mLSTM run
    and its first sLSTM block, as a model of their own: a config with the
    block at ``n_mlstm`` and its params (views, no copy)."""
    from repro_torch.models.xlstm_model import segments
    from repro_torch.tree import tree_map
    first, block = segments(cfg)[:2]
    require(first[0] == "m" and block[0] == "s" and n_mlstm <= first[2],
            f"{cfg.name}: no {n_mlstm} mLSTM layers before an sLSTM block")
    cut = dataclasses.replace(cfg, n_layers=n_mlstm + 1, slstm_at=(n_mlstm,))
    return cut, dict(
        {k: params[k] for k in ("embed", "final_norm", "lm_head", "seg1")},
        seg0=tree_map(lambda t: t[:n_mlstm], params["seg0"]))


def _xlstm_direct(dev, cfg, params, prompt, max_new: int) -> list:
    """One request by a direct ``decode_step`` loop at batch 1, under the
    engine's feeding rule (every prompt token, then ``prompt[-1]`` again,
    then each generated token): per generated step (greedy token, top-2
    logit margin, max|logit|)."""
    import torch
    from repro_torch.models import xlstm_model
    cache = xlstm_model.init_decode_cache(cfg, 1, device=dev)
    toks = torch.from_numpy(prompt.astype("int64")).to(dev).reshape(-1, 1, 1)
    for t in range(toks.shape[0]):
        _, cache = xlstm_model.decode_step(params, cfg, cache, toks[t])
    tok, out = toks[-1], []
    for _ in range(max_new):
        logits, cache = xlstm_model.decode_step(params, cfg, cache, tok)
        row = logits[0, 0].float()
        top2 = row.topk(2).values
        out.append((int(row.argmax()), float(top2[0] - top2[1]),
                    float(row.abs().max())))
        tok = row.argmax().reshape(1, 1)
    return out


def _first_flips(reqs, loops) -> list:
    """Per request, the first step whose engine token differs from the
    direct loop's (after it the two are fed different tokens):
    (request, step, the loop's top-2 margin, its max|logit|)."""
    flips = []
    for r, loop in zip(reqs, loops):
        for i, (tok, (want, margin, top)) in enumerate(zip(r.generated,
                                                           loop)):
            if tok != want:
                flips.append((r.req_id, i, margin, top))
                break
    return flips


def phase_serve_xlstm(dev, sz: Sizes, table):
    """``ServingEngine`` on xLSTM-125M at published width and depth (12
    blocks, d 768, 4 heads, vocab 50,304, sLSTM at 5 and 11), random bf16
    weights from a seed, greedy, the ``serve`` phase's requests at
    ``max_batch`` 4 and a 1,024-token context over an exact-fit pool (the
    family has no KV pages: its decode state is pinned whole, 23,679,136 B
    a sequence, and the engine copies it into and out of a batch slot
    every step); counters zeroed just before and read just after: no
    kernel of this repo is on the path, so each count must be 0.  Each
    step's logits are checked finite on the device (two small launches a
    step inside the timed run).  Then the pinned bytes a step and their
    copies' device ms, a batch-1 step profiled, and in float32 on the
    model's first ``xlstm_check_mlstm`` mLSTM layers and first sLSTM block
    the engine's greedy tokens
    at ``max_batch`` 1 and 4 against a direct ``decode_step`` loop per
    request: a token may differ only where the loop's top-2 margin is
    below ``XLSTM_FLIP_OF_MAX`` x max|logit| (cuBLAS may round an M=4
    product otherwise than an M=1 product)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import xlstm_model
    from repro_torch.models.registry import model_for
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _arch_config(sz, sz.xlstm_arch)
    require(cfg.family == "xlstm", cfg.family)
    _free(dev)
    t0 = time.perf_counter()
    params = xlstm_model.init_params(cfg, 0, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))

    api = model_for(cfg)                # the registry's, as the engine's
    step = api.decode_step
    finite = []

    def recording_step(p, c, cache, tokens):
        logits, cache = step(p, c, cache, tokens)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    api.decode_step = recording_step
    kernels.reset_launch_counts()
    try:
        eng, reqs, wall = _serve(dev, sz, cfg, params, None)
    finally:
        api.decode_step = step
    counts = kernels.launch_counts()
    st = eng.stats
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    step_calls = prompt_tokens + st.decode_steps
    require(len(finite) == step_calls, f"{len(finite)} decode_step calls "
            f"recorded, {step_calls} expected")
    require(bool(torch.stack(finite).all()), "bf16 logits not finite")
    require(all(r.done and len(r.generated) == sz.max_new for r in reqs),
            "a request did not finish")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
            "token id out of range")
    require(not any(counts.values()), f"a kernel launched on a path "
            f"without attention or pages: {counts}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    moved = _step_bytes(dev, sz, cfg, eng, params, 10, pinned="xlstm")
    each = moved["per_sequence_each_way"]
    require(each["kv_pages_bytes"] == 0 and (
        each["xlstm_state_bytes"] == XLSTM_STATE_BYTES or not sz.full_width),
        f"pinned state a sequence: {each}")
    del eng
    profile = _decode_profile(dev, sz, cfg, params, 3)

    # float32 at the first layers: engine tokens against a direct loop
    ccfg, cparams = _xlstm_head(params, cfg, sz.xlstm_check_mlstm)
    fcfg = dataclasses.replace(ccfg, dtype="float32")
    fparams = tree_map(lambda t: t.float(), cparams)
    prompts = _prompts(sz.prompts, cfg.vocab_size)
    t0 = time.perf_counter()
    loops = [_xlstm_direct(dev, fcfg, fparams, p, sz.max_new)
             for p in prompts]
    loop_s = time.perf_counter() - t0
    check = {"layers": fcfg.n_layers, "slstm_at": list(fcfg.slstm_at),
             "dtype": "float32", "direct_loop_seconds": loop_s,
             "flip_bound_of_max_logit": XLSTM_FLIP_OF_MAX,
             "loop_min_top2_margin": min(m for lp in loops for _, m, _ in lp)}
    for mb in (1, sz.max_batch):
        _, reqs_f, wall_f = _serve(dev, dataclasses.replace(sz, max_batch=mb),
                                   fcfg, fparams, None)
        flips = _first_flips(reqs_f, loops)
        require(all(m < XLSTM_FLIP_OF_MAX * top for _, _, m, top in flips),
                f"float32 engine tokens at max_batch {mb} differ from the "
                f"direct loop on a clear margin: {flips}")
        check[f"max_batch_{mb}"] = {
            "wall_seconds": wall_f, "requests_equal": len(reqs_f) - len(flips),
            "steps_differing_on_a_tie": len(flips), "flips": flips}
    del fparams, cparams
    emit("serve_xlstm", arch=cfg.name, layers=cfg.n_layers,
         segments=xlstm_model.segments(cfg), d_model=cfg.d_model,
         heads=cfg.n_heads, vocab=cfg.vocab_size, params=n_params,
         param_bytes=_nbytes(params), dtype=cfg.dtype, init_seconds=init_s,
         max_batch=sz.max_batch, max_len=sz.pages_per_seq * cfg.kv_page_tokens,
         prompt_lengths=[len(r.prompt) for r in reqs],
         requests_done=sum(r.done for r in reqs),
         tokens_generated=st.tokens_generated, decode_steps=st.decode_steps,
         decode_step_calls=step_calls, wall_seconds=wall,
         generated_tokens_per_s=st.tokens_generated / wall,
         processed_tokens_per_s=(prompt_tokens + st.tokens_generated) / wall,
         bf16_logits_finite=True, spill_events=st.spill_events,
         max_memory_allocated=peak, launches=counts,
         bytes_moved_per_step=moved, batch1_decode_step=profile,
         float32_tokens_engine_vs_direct_loop=check,
         first_tokens=[r.generated[:4] for r in reqs])
    del params
    _free(dev)


# --------------------------------------------------- phase: remote_paging
REMOTE_STAT_KEYS = ("remote_reads", "remote_bytes_in", "remote_dst_faults",
                    "rapf_retransmits", "failovers", "pages_in",
                    "evictions", "simulated_us")
COPY_KERNELS = r"page_copy_kernel|page_bulk_kernel"


def _same_bits(a, b) -> bool:
    """Bit-for-bit equality of two tensors (or numpy arrays) of one dtype."""
    import numpy as np
    import torch
    if isinstance(a, torch.Tensor):
        ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))
    ints = np.dtype(f"u{a.dtype.itemsize}")
    return a.dtype == b.dtype and np.array_equal(a.view(ints), b.view(ints))


def _remote_store(dev, strategy, rows, page_bytes: int, pool_frames: int,
                  lookahead: int, **build):
    """``benchmarks/vmem_remote.py::_store_remote`` at ``rows``' size: a
    ``PagedTensorStore`` over ``RemoteFramePool.build`` (FAULTING landing
    buffer, pre-touched remote region) over a ``DeviceFramePool`` on
    ``dev``, the backing image written from ``rows``."""
    from repro_torch.api import FaultPolicy
    from repro_torch.memory.paged_store import PagedTensorStore
    from repro_torch.vmem import RemoteFramePool
    n, elems = rows.shape
    pool = RemoteFramePool.build(n_frames=pool_frames, page_elems=elems,
                                 n_pages=n, page_bytes=page_bytes,
                                 dtype=rows.dtype, device=dev, **build)
    store = PagedTensorStore(elems, pool_frames, n, dtype=rows.dtype,
                             policy=FaultPolicy(strategy,
                                                lookahead=lookahead),
                             pool=pool)
    for v in range(n):
        store.write_host(v, rows[v])
    return store


def _remote_pass(store, rows, pages, what: str, crash=None) -> dict:
    """Stream ``pages`` through ``store.access`` one page at a time, as the
    reference's scenario does: every gathered row against the seed's row
    bit for bit (copied to the host), the pass's last also against
    ``page_gather_ref`` of the pool's frame it came from.  ``crash = (i,
    fn)`` calls ``fn`` just before the ``i``-th access.  Returns the
    pass's stats deltas."""
    import torch
    from repro_torch.compat import torch_to_numpy
    from repro_torch.kernels.page_pack.ref import page_gather_ref
    dev = store.frames.device
    before = dataclasses.asdict(store.stats)
    sync(dev)
    t0 = time.perf_counter()
    bad = []
    for i, v in enumerate(pages):
        if crash is not None and i == crash[0]:
            crash[1]()
        out = store.access([v])
        if not _same_bits(torch_to_numpy(out[0]), rows[v]):
            bad.append(v)
    sync(dev)
    wall = time.perf_counter() - t0
    require(not bad, f"{what}: {len(bad)} rows differ from the backing "
            f"rows, first {bad[:8]}")
    idx = torch.as_tensor(store.frame_ids([pages[-1]]), dtype=torch.int32,
                          device=dev)
    require(_same_bits(out, page_gather_ref(store.frames, idx)),
            f"{what}: page_gather differs from page_gather_ref")
    after = dataclasses.asdict(store.stats)
    return dict(pass_=what, pages=len(pages), wall_s=wall, rows_exact=True,
                **{k: after[k] - before[k] for k in REMOTE_STAT_KEYS})


def _copies_profiled(dev, fn) -> dict:
    """Run ``fn`` under ``torch.profiler``: device ms of the page copies
    and of every kernel, and the host wall time (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        out = fn()
        return dict(out, copy_device_ms="not measured")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync(dev)
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and (e.self_device_time_total or 0) > 0]
    copies = [r for r in rows if re.search(COPY_KERNELS, r[2])]
    return dict(out, copy_device_ms=sum(r[0] for r in copies) / 1e3
                if copies else "not measured",
                copy_kernel_calls=sum(r[1] for r in copies),
                all_device_ms=sum(r[0] for r in rows) / 1e3)


def remote_paging_run(dev, page_bytes: int, seq_pages: int,
                      pool_frames: int) -> dict:
    """The reference's remote-paging scenario at ``page_bytes`` a page:
    a backing region of two sequences A and B of ``seq_pages`` pages each
    on a remote node, a device pool of ``pool_frames`` frames.  For each
    strategy, sequence A, then B (which evicts A), then A again (it
    re-reads over the fabric), every row bit for bit; then B once more
    under the profiler.  Then failover: a 4-node ring, primary on node 1
    and replica on node 2; A's pages written back (mirrored), B streamed,
    and node 1 crashed halfway through A's return trip.  Rows from seed 0;
    Touch-Ahead's and STREAM's lookahead 4."""
    import importlib.util

    import numpy as np
    from repro_torch import kernels
    from repro_torch.api import FabricConfig, Strategy
    from repro_torch.compat import canonicalize_dtype
    # bf16 host rows need ml_dtypes (compat.canonicalize_dtype)
    dtype = canonicalize_dtype(
        "bfloat16" if importlib.util.find_spec("ml_dtypes") else "float32")
    require(page_bytes % dtype.itemsize == 0, "page_bytes vs dtype")
    elems = page_bytes // dtype.itemsize
    n = 2 * seq_pages
    seed, lookahead = 0, 4
    rows = np.random.default_rng(seed).standard_normal(
        (n, elems), dtype=np.float32).astype(dtype)
    seq_a = list(range(seq_pages))
    seq_b = list(range(seq_pages, n))
    out = dict(dtype=dtype.name, page_bytes=page_bytes, page_elems=elems,
               backing_pages=n, backing_bytes=n * page_bytes,
               pool_frames=pool_frames, pool_bytes=pool_frames * page_bytes,
               lookahead=lookahead, seed=seed, strategies={})
    for strategy in (Strategy.TOUCH_A_PAGE, Strategy.TOUCH_AHEAD,
                     Strategy.STREAM):
        name = strategy.value
        c0 = kernels.launch_counts()
        store = _remote_store(dev, strategy, rows, page_bytes, pool_frames,
                              lookahead)
        t0 = time.perf_counter()
        passes = [_remote_pass(store, rows, seq_a, f"{name} A cold"),
                  _remote_pass(store, rows, seq_b, f"{name} B"),
                  _remote_pass(store, rows, seq_a, f"{name} A return")]
        wall = time.perf_counter() - t0
        cold = passes[0]
        require(cold["remote_dst_faults"] > 0 and cold["rapf_retransmits"]
                > 0, f"{name}: the cold pass took no destination fault or "
                f"RAPF retransmit: {cold}")
        require(passes[2]["remote_reads"] > 0,
                f"{name}: A's return trip read nothing over the fabric")
        prof = _copies_profiled(dev, lambda: _remote_pass(
            store, rows, seq_b, f"{name} B again (profiled)"))
        c1 = kernels.launch_counts()
        out["strategies"][name] = dict(
            wall_s=wall, passes=passes, profiled_pass=prof,
            totals={k: getattr(store.stats, k) for k in REMOTE_STAT_KEYS},
            launches={k: c1[k] - c0[k] for k in ("page_gather",
                                                  "page_scatter")})
        del store
    # failover: the primary backing node dies halfway through A's return
    store = _remote_store(dev, Strategy.TOUCH_AHEAD, rows, page_bytes,
                          pool_frames, lookahead,
                          config=FabricConfig(n_nodes=4, topology="ring"),
                          remote_node=1, replica_node=2)
    pool = store.pool
    t0 = time.perf_counter()
    p_a = _remote_pass(store, rows, seq_a, "failover A cold")
    for v in seq_a:
        store.write_back(v)
    page_out_us = pool.page_out(None, 0, seq_pages)
    p_b = _remote_pass(store, rows, seq_b, "failover B")
    p_r = _remote_pass(store, rows, seq_a, "failover A return",
                       crash=(len(seq_a) // 2,
                              lambda: pool.fabric.crash_node(1)))
    wall = time.perf_counter() - t0
    require(pool.failed_over and pool.failovers > 0
            and p_r["failovers"] > 0, f"no failover: {p_r}")
    require(pool.ryw_violations == 0 and pool.ryw_verified > 0,
            f"read-your-writes: verified {pool.ryw_verified}, violations "
            f"{pool.ryw_violations}")
    out["failover"] = dict(
        config="4-node ring, primary node 1, replica node 2",
        crash="node 1 before access %d of A's return trip" % (
            len(seq_a) // 2), wall_s=wall,
        page_out_simulated_us=page_out_us, passes=[p_a, p_b, p_r],
        failovers=pool.failovers, ryw_verified=pool.ryw_verified,
        ryw_violations=pool.ryw_violations, rows_exact=True)
    return out


def phase_remote_paging(dev, sz: Sizes, table):
    """Remote paging at a Qwen3-14B KV page (256 tokens x 8 KV heads x 128
    x bf16 = 524,288 B): :func:`remote_paging_run` over a backing region
    of two preempted 1,024-token sequences (40 layers x 4 pages x K, V =
    320 pages each, 320 MB) and a device pool that holds one (160 MB).
    Counters zeroed just before, read just after; then one row's gather /
    scatter at this shape against the plain version and the library."""
    import torch
    from repro_torch import kernels
    from repro_torch.compat import torch_dtype
    from repro_torch.kernels.page_pack.ops import gather_pages, scatter_pages
    from repro_torch.kernels.page_pack.ref import (page_gather_ref,
                                                   page_scatter_ref)
    cfg = _arch_config(sz, sz.arch)
    page_bytes = cfg.kv_page_tokens * cfg.n_kv_heads * cfg.head_dim \
        * torch.empty(0, dtype=torch_dtype(cfg.dtype)).element_size()
    seq_pages = cfg.n_layers * sz.pages_per_seq * 2
    _free(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = remote_paging_run(dev, page_bytes, seq_pages,
                            pool_frames=seq_pages)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if dev.type == "cuda":
        require(counts["page_gather"] > 0 and counts["page_scatter"] > 0,
                f"page gather/scatter launches: {counts}")
        require(counts["paged_attention"] == 0
                and counts["flash_attention"] == 0,
                f"attention kernels on the remote-paging path: {counts}")
    _add_launches(table, "remote_paging", counts,
                  ("page_gather", "page_scatter"))

    # one row at this shape (the path's copies), after the counters; four
    # pools of a sequence's frames cycled, so a call finds the L2 cold
    one = {}
    if dev.type == "cuda":
        gen = torch.Generator(device=dev)
        gen.manual_seed(9)
        dt = torch_dtype(res["dtype"])
        pools = [_rand(gen, (seq_pages, res["page_elems"]), dt, dev)
                 for _ in range(4)]
        idx = [torch.tensor([(37 * i) % seq_pages], dtype=torch.int32,
                            device=dev) for i in range(4)]
        blk = _rand(gen, (1, res["page_elems"]), dt, dev)

        def timed(fn):
            return time_ms(dev, [lambda p=p, i=i: fn(p, i)
                                 for p, i in zip(pools, idx)],
                           sz.timing_iters)

        one = dict(
            gather_ms=timed(gather_pages),
            gather_plain_ms=timed(page_gather_ref),
            index_select_ms=timed(lambda p, i: torch.index_select(p, 0, i)),
            scatter_ms=timed(lambda p, i: scatter_pages(p, i, blk)),
            scatter_plain_ms=timed(lambda p, i: page_scatter_ref(p, i, blk)),
            index_copy_ms=timed(lambda p, i: p.index_copy_(0, i.long(),
                                                           blk)),
            empty_kernel_ms=_copy_floor_ms(dev, 1, page_bytes,
                                           sz.timing_iters),
            bound_ms=2 * page_bytes / HBM_BYTES_PER_S * 1e3,
            plan=_copy_plan_of(dev, 1, page_bytes))
        del pools
        _free(dev)
    emit("remote_paging", arch=cfg.name,
         scenario="benchmarks/vmem_remote.py::_store_remote: "
         "PagedTensorStore(pool=RemoteFramePool.build(...))",
         sequence_pages=seq_pages, wall_seconds=wall, launches=counts,
         copy_one_row=one, **res)


# ----------------------------------------------------- phase: train parity
def _to(tree, dev):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def phase_train_parity(dev, sz: Sizes, cfg):
    """Full width, ``parity_layers`` layers, f32, one batch of
    ``parity_batch`` x ``parity_seq``: loss and every leaf's gradient by
    the kernel path on the card (remat on: the forward kernel runs again in
    the backward) against the plain path on the CPU (remat off: the same
    function); then one AdamW update of each from the same gradients; then
    ``PagedAdamW`` against AdamW on the card.

    Tolerances: loss 1e-5 relative; gradients 1e-4 x max|ref| per leaf (f32
    sums over d_model 5120 and d_ff 17408 in another order, through two
    layers, the norms and the vocabulary projection); the update 2e-5
    (atol = rtol, f32 elementwise).  The CPU's results are compared on the
    card (the same elementwise f32 arithmetic, without the host's passes
    over two billion elements); ``seconds`` says where the phase's time
    goes."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.memory.offload import PagedAdamW
    from repro_torch.models import decoder
    from repro_torch.optim import adamw
    from repro_torch.training.trainer import (TrainConfig, make_loss_fn,
                                              value_and_grad)
    from repro_torch.tree import tree_leaves, tree_names

    pcfg = dataclasses.replace(cfg, n_layers=sz.parity_layers,
                               dtype="float32")
    secs, t_phase = {}, time.perf_counter()
    params = decoder.init_params(pcfg, 5, device=dev)
    cpu = torch.device("cpu")
    params_cpu = _to(params, cpu)
    secs["init_and_copy_to_host"] = time.perf_counter() - t_phase
    tokens, labels = SyntheticLM(pcfg.vocab_size, sz.parity_seq,
                                 sz.parity_batch, seed=5).batch_at(0)
    tok, lab = torch.from_numpy(tokens), torch.from_numpy(labels)

    before = kernels.launch_counts()
    t0 = time.perf_counter()
    loss_k, g_k = value_and_grad(make_loss_fn(pcfg, TrainConfig(remat=True)),
                                 params, tok.to(dev), lab.to(dev))
    sync(dev)
    kernel_s = time.perf_counter() - t0
    after = kernels.launch_counts()
    fwd = after["flash_attention"] - before["flash_attention"]
    bwd = after["flash_attention_bwd"] - before["flash_attention_bwd"]
    require(dev.type != "cuda" or (fwd == 2 * pcfg.n_layers
                                   and bwd == pcfg.n_layers),
            f"train_parity: flash launches fwd {fwd} bwd {bwd}, expected "
            f"{2 * pcfg.n_layers} and {pcfg.n_layers}")
    t0 = time.perf_counter()
    loss_p, g_p = value_and_grad(
        make_loss_fn(pcfg, TrainConfig(remat=False)), params_cpu, tok, lab)
    plain_s = time.perf_counter() - t0
    secs.update(kernel_path=kernel_s, plain_cpu=plain_s)
    t0 = time.perf_counter()
    loss_err = abs(float(loss_k) - float(loss_p))
    require(math.isfinite(float(loss_k)) and
            loss_err <= 1e-5 * abs(float(loss_p)),
            f"train_parity loss {float(loss_k)} vs {float(loss_p)}")
    grad_errs = {}
    for n, a, b in zip(tree_names(g_k), tree_leaves(g_k), tree_leaves(g_p)):
        b = b.to(dev)
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        require(bool(torch.isfinite(a).all()) and err <= 1e-4 * scale,
                f"train_parity grad {n}: max abs err {err}, max|ref| {scale}")
        grad_errs[n] = err / scale if scale else err
    del g_k, b
    secs["grad_compare"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    ocfg = adamw.AdamWConfig(lr=1e-3)
    state_k = adamw.init(ocfg, params)
    state_p = adamw.init(ocfg, params_cpu)
    adamw.update(ocfg, state_k, params, _to(g_p, dev))
    _, _, m_p = adamw.update(ocfg, state_p, params_cpu, g_p)
    sync(dev)
    secs["adamw_updates"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    upd_err = 0.0
    for n, a, b in zip(tree_names(params), tree_leaves(params),
                       tree_leaves(params_cpu)):
        upd_err = max(upd_err, check_close(a, b.to(dev), TOL["float32"],
                                           f"adamw.update {n}"))
    del params, params_cpu, state_k, state_p, g_p
    secs["update_compare"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # PagedAdamW on the card: host-paged moments, page gather / scatter
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    small = {"w": _rand(gen, (1024, 2048), torch.float32, dev),
             "b": _rand(gen, (4096,), torch.float32, dev)}
    grads = [{k: _rand(gen, t.shape, torch.float32, dev)
              for k, t in small.items()} for _ in range(3)]
    ocfg = adamw.AdamWConfig(lr=1e-2, grad_clip=0.0, weight_decay=0.01)
    po = PagedAdamW(ocfg, small, block_elems=1 << 18, device=dev)
    plain = {k: t.clone() for k, t in small.items()}
    state = adamw.init(ocfg, plain)
    paged = small
    before = kernels.launch_counts()
    for g in grads:
        paged = po.update(paged, g)
        adamw.update(ocfg, state, plain, g)
    sync(dev)
    after = kernels.launch_counts()
    paged_err = max(check_close(paged[k], plain[k], 1e-5,
                                f"PagedAdamW {k}") for k in plain)
    require(dev.type != "cuda" or (
        after["page_gather"] > before["page_gather"]
        and after["page_scatter"] > before["page_scatter"]),
            "PagedAdamW did not page through the copy kernels")
    require(po.stats.prefetch_overlapped > 0, "PagedAdamW: no overlap")
    secs["paged_adamw"] = time.perf_counter() - t0
    emit("train_parity", layers=pcfg.n_layers, d_model=pcfg.d_model,
         vocab=pcfg.vocab_size, dtype=pcfg.dtype, batch=sz.parity_batch,
         seq=sz.parity_seq, loss_kernel=float(loss_k),
         loss_plain_cpu=float(loss_p), loss_abs_err=loss_err,
         grad_rel_err_max=max(grad_errs.values()), grad_rel_err=grad_errs,
         grad_tolerance="1e-4 x max|ref| per leaf",
         adamw_update_max_abs_err=upd_err, adamw_lr=float(m_p["lr"]),
         kernel_path_seconds=kernel_s, plain_cpu_seconds=plain_s,
         seconds=secs, flash_launches={"fwd": fwd, "bwd": bwd},
         paged_adamw={"params": sum(t.numel() for t in small.values()),
                      "blocks_streamed": po.stats.blocks_streamed,
                      "faults": po.stats.faults,
                      "prefetch_overlapped": po.stats.prefetch_overlapped,
                      "max_abs_err": paged_err,
                      "page_gather_launches": after["page_gather"]
                      - before["page_gather"],
                      "page_scatter_launches": after["page_scatter"]
                      - before["page_scatter"]})


# -------------------------------------------------------------- phase: train
def phase_train(dev, sz: Sizes, cfg, table, with_profile: bool = False):
    """``Trainer`` on Qwen3-14B at published width, ``train_layers`` deep:
    ``train_steps`` steps (counters zeroed just before, read just after),
    a checkpoint after step ``checkpoint_step`` restored into a fresh
    trainer, whose next step must give the same loss.  With
    ``with_profile``, one more step (two, the first unprofiled) after the
    counters are read, under ``torch.profiler``."""
    import gc
    import shutil
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.checkpoint import Checkpointer
    from repro_torch.models import decoder
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves

    tcfg_model = dataclasses.replace(cfg, n_layers=sz.train_layers)
    tcfg = TrainConfig(microbatches=sz.train_microbatches, remat=True,
                       optimizer=AdamWConfig(lr=3e-4,
                                             moment_dtype="float32"))
    ds = SyntheticLM(cfg.vocab_size, sz.train_seq, sz.train_batch, seed=0)
    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_checkpoints")
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = Checkpointer()
    on_card = dev.type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = decoder.init_params(tcfg_model, 0, device=dev)
    tr = Trainer(tcfg_model, tcfg, params, ds, device=dev)
    del params
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    tokens_per_step = sz.train_batch * sz.train_seq

    steps, save_s = [], None
    kernels.reset_launch_counts()
    for i in range(sz.train_steps):
        t0 = time.perf_counter()
        tr.run(1, log_every=0)
        sync(dev)
        wall = time.perf_counter() - t0
        rec = dict(tr.history[-1], wall_s=wall,
                   tokens_per_s=tokens_per_step / wall)
        steps.append(rec)
        if tr.step == sz.checkpoint_step:
            t0 = time.perf_counter()
            ck.save(ckdir, tr.params, tr.opt_state, tr.step)
            save_s = time.perf_counter() - t0
    counts = _launches()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    profile = _profiled(dev, lambda: tr.run(1, log_every=0), 1) \
        if with_profile else None
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in steps), f"non-finite loss: {steps}")
    per_step = sz.train_microbatches * sz.train_layers
    require(not on_card or (
        counts["flash_attention"] == 2 * per_step * sz.train_steps
        and counts["flash_attention_bwd"] == per_step * sz.train_steps
        and counts["flash_wgmma_fwd"] == counts["flash_attention"]),
        f"flash launches on the train path: {counts}")
    after_ckpt = steps[sz.checkpoint_step]          # the step after the save
    del tr
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    params = decoder.init_params(tcfg_model, 1, device=dev)
    tr2 = Trainer(tcfg_model, tcfg, params, ds, checkpoint_dir=ckdir,
                  checkpointer=ck, device=dev)
    del params
    t0 = time.perf_counter()
    require(tr2.restore() and tr2.step == sz.checkpoint_step,
            "checkpoint did not restore")
    sync(dev)
    restore_s = time.perf_counter() - t0
    tr2.run(1, log_every=0)
    again = tr2.history[-1]
    shutil.rmtree(ckdir, ignore_errors=True)
    diff = abs(again["loss"] - after_ckpt["loss"])
    require(diff <= 1e-6 * abs(after_ckpt["loss"]),
            f"loss after restore {again['loss']} != {after_ckpt['loss']}")
    del tr2
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    _add_launches(table, "train", counts,
                  FLASH_TRAIN)
    emit("train", arch=cfg.name, layers=sz.train_layers, d_model=cfg.d_model,
         params=n_params, dtype=cfg.dtype, moment_dtype="float32",
         seq=sz.train_seq, global_batch=sz.train_batch,
         microbatches=sz.train_microbatches, remat=True,
         init_seconds=init_s, steps=steps,
         mean_tokens_per_s_after_first=(
             sum(r["tokens_per_s"] for r in steps[1:]) / (len(steps) - 1)
             if len(steps) > 1 else None),
         max_memory_allocated=peak, launches=counts,
         checkpoint={"step": sz.checkpoint_step, "save_seconds": save_s,
                     "restore_seconds": restore_s,
                     "loss_step_after": after_ckpt["loss"],
                     "loss_step_after_restored": again["loss"],
                     "abs_diff": diff}, profile=profile)


# ----------------------------------------------------------- phase: train_mla
MLA_PARITY_TOL = {"loss_rel": 1e-5, "grad_of_max": 1e-4}    # float32


def _mla_train_parity(dev, sz: Sizes, cfg) -> dict:
    """One layer of DeepSeek-V3 at published width in float32, one
    sequence of ``mla_parity_seq``, remat: loss and every leaf's gradient by
    the kernel path (flash at head_dim 192, the CUDA-core route) against
    the plain path (the chunked ``flash_attention_xla``), both on the card.
    Held as ``train_parity`` holds the dense model: loss within 1e-5
    relative, each gradient leaf within 1e-4 x max|ref| (f32 sums over
    d_model 7168 and 128 heads in another order)."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import decoder
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.attention_ops import flash_attention_xla
    from repro_torch.training.trainer import (TrainConfig, make_loss_fn,
                                              value_and_grad)
    from repro_torch.tree import tree_leaves, tree_names

    pcfg = dataclasses.replace(cfg, n_layers=1,
                               first_k_dense=min(cfg.first_k_dense, 1),
                               dtype="float32")
    params = decoder.init_params(pcfg, 7, device=dev)
    tokens, labels = SyntheticLM(pcfg.vocab_size, sz.mla_parity_seq, 1,
                                 seed=7).batch_at(0)
    tok = torch.from_numpy(tokens).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    loss_fn = make_loss_fn(pcfg, TrainConfig(remat=True))
    before = kernels.launch_counts()
    loss_k, g_k = value_and_grad(loss_fn, params, tok, lab)
    sync(dev)
    after = kernels.launch_counts()
    # MLA's training attention reaches flash through attention's region
    kernel_fn = attn_mod.flash_attention
    attn_mod.flash_attention = flash_attention_xla         # plain, on card
    try:
        loss_p, g_p = value_and_grad(loss_fn, params, tok, lab)
        sync(dev)
    finally:
        attn_mod.flash_attention = kernel_fn
    fwd = after["flash_attention"] - before["flash_attention"]
    bwd = after["flash_attention_bwd"] - before["flash_attention_bwd"]
    require(dev.type != "cuda" or (fwd == 2 and bwd == 1),
            f"train_mla parity: flash launches fwd {fwd} bwd {bwd}")
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    require(math.isfinite(float(loss_k))
            and loss_rel <= MLA_PARITY_TOL["loss_rel"],
            f"train_mla parity: loss {float(loss_k)} vs {float(loss_p)}")
    grad_of_max = {}
    for n, a, b in zip(tree_names(g_k), tree_leaves(g_k), tree_leaves(g_p)):
        require(bool(torch.isfinite(a).all()), f"grad {n} not finite")
        grad_of_max[n] = float((a - b).abs().max()
                               / b.abs().max().clamp_min(1e-30))
    worst = max(grad_of_max, key=grad_of_max.get)
    require(grad_of_max[worst] <= MLA_PARITY_TOL["grad_of_max"],
            f"train_mla parity: grad {worst} max abs err "
            f"{grad_of_max[worst]} x max|ref|")
    del params, g_k, g_p
    return {"layers": 1, "dtype": "float32", "seq": sz.mla_parity_seq,
            "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel_err": loss_rel, "grad_err_of_max": grad_of_max,
            "tolerance": MLA_PARITY_TOL,
            "flash_launches": {"fwd": fwd, "bwd": bwd}}


def phase_train_mla(dev, sz: Sizes, table):
    """``Trainer`` on DeepSeek-V3 at published width cut to
    ``mla_train_layers`` (its first_k_dense dense layers: one MoE layer
    alone is 11.3 B parameters, ~135 GB with f32 moments), random weights
    from a seed: first the one-layer kernel-path / plain-path parity, then
    ``mla_train_steps`` steps at the train shape (seq 4096, batch 2 in 2
    microbatches, remat, bf16 params, f32 moments), counters zeroed just
    before the steps and read just after: flash attention at head_dim 192
    (q and k nope 128 + rope 64, v zero-padded to 192), finite losses."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import decoder
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves

    cfg = _arch_config(sz, sz.mla_arch, n_layers=sz.mla_train_layers)
    require(cfg.family == "mla_moe", cfg.family)
    _free(dev)
    parity = _mla_train_parity(dev, sz, cfg)
    _free(dev)

    tcfg = TrainConfig(microbatches=sz.train_microbatches, remat=True,
                       optimizer=AdamWConfig(lr=3e-4,
                                             moment_dtype="float32"))
    ds = SyntheticLM(cfg.vocab_size, sz.train_seq, sz.train_batch, seed=0)
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, 0, device=dev)
    tr = Trainer(cfg, tcfg, params, ds, device=dev)
    del params
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    tokens_per_step = sz.train_batch * sz.train_seq
    steps = []
    kernels.reset_launch_counts()
    for _ in range(sz.mla_train_steps):
        t0 = time.perf_counter()
        tr.run(1, log_every=0)
        sync(dev)
        wall = time.perf_counter() - t0
        steps.append(dict(tr.history[-1], wall_s=wall,
                          tokens_per_s=tokens_per_step / wall))
    counts = _launches()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in steps), f"train_mla: non-finite loss: {steps}")
    per_step = sz.train_microbatches * cfg.n_layers
    require(dev.type != "cuda" or (
        counts["flash_attention"] == 2 * per_step * sz.mla_train_steps
        and counts["flash_attention_bwd"] == per_step * sz.mla_train_steps
        and counts["flash_wgmma_fwd"] == counts["flash_attention"]),
        f"flash launches on the train_mla path: {counts}")
    _add_launches(table, "train_mla", counts,
                  FLASH_TRAIN)
    emit("train_mla", arch=cfg.name, layers=cfg.n_layers,
         first_k_dense=cfg.first_k_dense, d_model=cfg.d_model,
         heads=cfg.n_heads, q_lora_rank=cfg.q_lora_rank,
         kv_lora_rank=cfg.kv_lora_rank,
         qk_head_dim=cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
         v_head_dim=cfg.v_head_dim, vocab=cfg.vocab_size, params=n_params,
         dtype=cfg.dtype, moment_dtype="float32", seq=sz.train_seq,
         global_batch=sz.train_batch, microbatches=sz.train_microbatches,
         remat=True, init_seconds=init_s, steps=steps,
         mean_tokens_per_s_after_first=(
             sum(r["tokens_per_s"] for r in steps[1:]) / (len(steps) - 1)
             if len(steps) > 1 else None),
         max_memory_allocated=peak, launches=counts, parity=parity)
    del tr
    _free(dev)


# -------------------------------------------------------- phase: train_hybrid
# float32, as train_mla holds its parity: A_log's gradient, a sum over
# every position, head and channel, moves by ~1e-5 x max|ref| with the
# attention's summation order alone (on the H100, kernel against plain
# 1.07e-5, plain at 256-row chunks against plain at 512 1.34e-5: the
# ``plain_noise_grad_err_of_max`` beside the errors)
HYBRID_PARITY_TOL = MLA_PARITY_TOL


def _hybrid_train_parity(dev, sz: Sizes, cfg) -> dict:
    """One group of Zamba2-7B at published width (6 Mamba2 layers and the
    shared block, no tail) in float32, one sequence of
    ``hybrid_parity_seq``, remat: loss and every leaf's gradient by the
    kernel path (flash at head_dim 112, the CUDA-core route) against the
    plain path (the chunked ``flash_attention_xla``), both on the card;
    the Mamba layers run the same ops on both.  Loss within 1e-5
    relative, each gradient leaf finite and within 1e-4 x max|ref|.  The
    plain path at 256-row chunks against itself at 512 is reported beside
    it: the f32 noise of the same function summed in another order."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import hybrid
    from repro_torch.models.attention_ops import flash_attention_xla
    from repro_torch.training.trainer import (TrainConfig, make_loss_fn,
                                              value_and_grad)
    from repro_torch.tree import tree_leaves, tree_names

    pcfg = dataclasses.replace(cfg, n_layers=cfg.attn_every, dtype="float32")
    require(hybrid.group_layout(pcfg)[::2] == (1, 0), "one group, no tail")
    params = hybrid.init_params(pcfg, 7, device=dev)
    tokens, labels = SyntheticLM(pcfg.vocab_size, sz.hybrid_parity_seq, 1,
                                 seed=7).batch_at(0)
    tok = torch.from_numpy(tokens).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    loss_fn = make_loss_fn(pcfg, TrainConfig(remat=True))
    before = kernels.launch_counts()
    loss_k, g_k = value_and_grad(loss_fn, params, tok, lab)
    sync(dev)
    after = kernels.launch_counts()
    kernel_fn = attn_mod.flash_attention
    attn_mod.flash_attention = flash_attention_xla         # plain, on card
    try:
        loss_p, g_p = value_and_grad(loss_fn, params, tok, lab)
        _, g_n = value_and_grad(
            lambda p, t, l: hybrid.loss_fn(p, pcfg, t, l, remat=True,
                                           q_chunk=256, kv_chunk=256),
            params, tok, lab)
        sync(dev)
    finally:
        attn_mod.flash_attention = kernel_fn
    noise = {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
             for n, a, b in zip(tree_names(g_n), tree_leaves(g_n),
                                tree_leaves(g_p))}
    fwd = after["flash_attention"] - before["flash_attention"]
    bwd = after["flash_attention_bwd"] - before["flash_attention_bwd"]
    require(dev.type != "cuda" or (fwd == 2 and bwd == 1),
            f"train_hybrid parity: flash launches fwd {fwd} bwd {bwd}")
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    require(math.isfinite(float(loss_k))
            and loss_rel <= HYBRID_PARITY_TOL["loss_rel"],
            f"train_hybrid parity: loss {float(loss_k)} vs {float(loss_p)}")
    grad_of_max = {}
    for n, a, b in zip(tree_names(g_k), tree_leaves(g_k), tree_leaves(g_p)):
        require(bool(torch.isfinite(a).all()), f"grad {n} not finite")
        grad_of_max[n] = float((a - b).abs().max()
                               / b.abs().max().clamp_min(1e-30))
    worst = max(grad_of_max, key=grad_of_max.get)
    require(grad_of_max[worst] <= HYBRID_PARITY_TOL["grad_of_max"],
            f"train_hybrid parity: grad {worst} max abs err "
            f"{grad_of_max[worst]} x max|ref|")
    del params, g_k, g_p, g_n
    return {"layers": pcfg.n_layers, "groups": 1, "dtype": "float32",
            "seq": sz.hybrid_parity_seq, "loss_kernel": float(loss_k),
            "loss_plain": float(loss_p), "loss_rel_err": loss_rel,
            "grad_err_of_max": grad_of_max, "tolerance": HYBRID_PARITY_TOL,
            "plain_noise_grad_err_of_max": noise,
            "flash_launches": {"fwd": fwd, "bwd": bwd}}


def phase_train_hybrid(dev, sz: Sizes, table):
    """``Trainer`` on Zamba2-7B at published width cut to
    ``hybrid_train_layers`` (2 groups of 6 and a 3-layer tail, so the tail
    runs), random weights from a seed: first the one-group kernel-path /
    plain-path parity, then ``hybrid_train_steps`` steps at the train
    shape (seq 4096, batch 2 in 2 microbatches, remat, bf16 params, f32
    moments), counters zeroed just before the steps and read just after:
    flash at head_dim 112, finite losses and finite gradients (the global
    gradient norm is finite only if every gradient is: the reference's
    Mamba2 scan gives NaN gradients at this chunk of 128, the port's
    masked exponent does not)."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import hybrid
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves

    cfg = _arch_config(sz, sz.zamba_arch, n_layers=sz.hybrid_train_layers)
    G, k, tail = hybrid.group_layout(cfg)
    require(cfg.family == "hybrid" and tail > 0, f"{cfg.name}: no tail")
    _free(dev)
    parity = _hybrid_train_parity(dev, sz, cfg)
    _free(dev)

    tcfg = TrainConfig(microbatches=sz.train_microbatches, remat=True,
                       optimizer=AdamWConfig(lr=3e-4,
                                             moment_dtype="float32"))
    ds = SyntheticLM(cfg.vocab_size, sz.train_seq, sz.train_batch, seed=0)
    t0 = time.perf_counter()
    params = hybrid.init_params(cfg, 0, device=dev)
    tr = Trainer(cfg, tcfg, params, ds, device=dev)
    del params
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    tokens_per_step = sz.train_batch * sz.train_seq
    steps = []
    kernels.reset_launch_counts()
    for _ in range(sz.hybrid_train_steps):
        t0 = time.perf_counter()
        tr.run(1, log_every=0)
        sync(dev)
        wall = time.perf_counter() - t0
        steps.append(dict(tr.history[-1], wall_s=wall,
                          tokens_per_s=tokens_per_step / wall))
    counts = _launches()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in steps), f"train_hybrid: non-finite loss or "
            f"gradient: {steps}")
    per_step = sz.train_microbatches * G
    require(dev.type != "cuda" or (
        counts["flash_attention"] == 2 * per_step * sz.hybrid_train_steps
        and counts["flash_attention_bwd"] == per_step
        * sz.hybrid_train_steps
        and counts["flash_wgmma_fwd"] == counts["flash_attention"]),
        f"flash launches on the train_hybrid path: {counts}")
    _add_launches(table, "train_hybrid", counts,
                  FLASH_TRAIN)
    emit("train_hybrid", arch=cfg.name, layers=cfg.n_layers, groups=G,
         group_size=k, tail=tail, d_model=cfg.d_model, heads=cfg.n_heads,
         head_dim=cfg.head_dim, vocab=cfg.vocab_size, params=n_params,
         dtype=cfg.dtype, moment_dtype="float32", seq=sz.train_seq,
         ssm_chunk=128, global_batch=sz.train_batch,
         microbatches=sz.train_microbatches, remat=True, init_seconds=init_s,
         steps=steps, mean_tokens_per_s_after_first=(
             sum(r["tokens_per_s"] for r in steps[1:]) / (len(steps) - 1)
             if len(steps) > 1 else None),
         max_memory_allocated=peak, launches=counts, parity=parity)
    del tr
    _free(dev)


# -------------------------------------------------------- phase: train_encdec
ENCDEC_PARITY_TOL = MLA_PARITY_TOL


def _encdec_train_parity(dev, sz: Sizes, cfg) -> dict:
    """Whisper-medium at published width cut to ``whisper_parity_layers``
    encoder and decoder layers, float32, one sequence of
    ``max_target_positions`` tokens over random frame embeddings (so that
    cross-attention's backward sees real values), remat: loss and every
    leaf's gradient by the kernel path (flash on the encoder, the
    decoder's self-attention and the cross-attention at Sq 448 over Sk
    1,500: the CUDA-core route) against the plain path on the card
    (``flash_attention_xla`` for all three).  Loss within 1e-5 relative,
    each gradient leaf finite and within 1e-4 x max|ref|."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import encdec
    from repro_torch.models.attention_ops import flash_attention_xla
    from repro_torch.training.trainer import (TrainConfig, make_loss_fn,
                                              value_and_grad)
    from repro_torch.tree import tree_leaves, tree_names

    n = sz.whisper_parity_layers
    pcfg = dataclasses.replace(cfg, n_layers=n, n_enc_layers=n,
                               dtype="float32")
    params = encdec.init_params(pcfg, 7, device=dev)
    S = pcfg.max_target_positions
    tokens, labels = SyntheticLM(pcfg.vocab_size, S, 1, seed=7).batch_at(0)
    tok = torch.from_numpy(tokens).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    frames = torch.randn((1, pcfg.max_source_positions, pcfg.d_model),
                         generator=gen, device=dev)
    loss_fn = make_loss_fn(pcfg, TrainConfig(remat=True))
    before = kernels.launch_counts()
    loss_k, g_k = value_and_grad(loss_fn, params, tok, lab, frames)
    sync(dev)
    after = kernels.launch_counts()
    kernel_fn = attn_mod.flash_attention
    attn_mod.flash_attention = flash_attention_xla        # plain, on card
    try:
        loss_p, g_p = value_and_grad(loss_fn, params, tok, lab, frames)
        sync(dev)
    finally:
        attn_mod.flash_attention = kernel_fn
    fwd = after["flash_attention"] - before["flash_attention"]
    bwd = after["flash_attention_bwd"] - before["flash_attention_bwd"]
    per_pass = 2 * n + n                 # encoder, decoder self, cross
    require(dev.type != "cuda" or (fwd == 2 * per_pass and bwd == per_pass),
            f"train_encdec parity: flash launches fwd {fwd} bwd {bwd}")
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    require(math.isfinite(float(loss_k))
            and loss_rel <= ENCDEC_PARITY_TOL["loss_rel"],
            f"train_encdec parity: loss {float(loss_k)} vs {float(loss_p)}")
    grad_of_max = {}
    for name, a, b in zip(tree_names(g_k), tree_leaves(g_k),
                          tree_leaves(g_p)):
        require(bool(torch.isfinite(a).all()), f"grad {name} not finite")
        grad_of_max[name] = float((a - b).abs().max()
                                  / b.abs().max().clamp_min(1e-30))
    worst = max(grad_of_max, key=grad_of_max.get)
    require(grad_of_max[worst] <= ENCDEC_PARITY_TOL["grad_of_max"],
            f"train_encdec parity: grad {worst} max abs err "
            f"{grad_of_max[worst]} x max|ref|")
    del params, g_k, g_p
    return {"encoder_layers": n, "decoder_layers": n, "dtype": "float32",
            "seq": S, "frames": pcfg.max_source_positions,
            "frame_embeddings": "random", "loss_kernel": float(loss_k),
            "loss_plain": float(loss_p), "loss_rel_err": loss_rel,
            "grad_err_of_max": grad_of_max, "worst_leaf": worst,
            "tolerance": ENCDEC_PARITY_TOL,
            "flash_launches": {"fwd": fwd, "bwd": bwd}}


def phase_train_encdec(dev, sz: Sizes, table, with_profile: bool = False):
    """``Trainer`` on Whisper-medium at published width and depth (24 + 24
    layers), random weights from a seed: first the two-layer f32
    kernel-path / plain-path parity over random frames, then
    ``whisper_train_steps`` steps of tokens (8, 448) in 2 microbatches,
    remat, bf16 params, f32 moments, on ``SyntheticLM`` (zero frames, as
    in the reference's trainer), counters zeroed just before the steps and
    read just after: flash on the encoder (S 1,500, non-causal), the
    decoder (448, causal) and the cross-attention (448 over 1,500), finite
    losses and gradient norms.  With ``with_profile``, one more step (two,
    the first unprofiled) under ``torch.profiler``."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import encdec
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves

    cfg = _arch_config(sz, sz.whisper_arch)
    require(cfg.family == "encdec", cfg.family)
    _free(dev)
    parity = _encdec_train_parity(dev, sz, cfg)
    _free(dev)

    seq = cfg.max_target_positions
    tcfg = TrainConfig(microbatches=sz.train_microbatches, remat=True,
                       optimizer=AdamWConfig(lr=3e-4,
                                             moment_dtype="float32"))
    ds = SyntheticLM(cfg.vocab_size, seq, sz.whisper_train_batch, seed=0)
    t0 = time.perf_counter()
    params = encdec.init_params(cfg, 0, device=dev)
    tr = Trainer(cfg, tcfg, params, ds, device=dev)
    del params
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    tokens_per_step = sz.whisper_train_batch * seq
    steps = []
    kernels.reset_launch_counts()
    for _ in range(sz.whisper_train_steps):
        t0 = time.perf_counter()
        tr.run(1, log_every=0)
        sync(dev)
        wall = time.perf_counter() - t0
        steps.append(dict(tr.history[-1], wall_s=wall,
                          tokens_per_s=tokens_per_step / wall))
    counts = _launches()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in steps), f"train_encdec: non-finite loss or "
            f"gradient: {steps}")
    per_step = sz.train_microbatches * (cfg.n_enc_layers + 2 * cfg.n_layers)
    require(dev.type != "cuda" or (
        counts["flash_attention"] == 2 * per_step * sz.whisper_train_steps
        and counts["flash_attention_bwd"] == per_step
        * sz.whisper_train_steps
        and counts["flash_wgmma_fwd"] == counts["flash_attention"]),
        f"flash launches on the train_encdec path: {counts}")
    _add_launches(table, "train_encdec", counts,
                  FLASH_TRAIN)
    profile = _profiled(dev, lambda: tr.run(1, log_every=0), 1) \
        if with_profile else None
    emit("train_encdec", arch=cfg.name, layers=cfg.n_layers,
         encoder_layers=cfg.n_enc_layers, d_model=cfg.d_model,
         heads=cfg.n_heads, head_dim=cfg.head_dim, vocab=cfg.vocab_size,
         source_frames=cfg.max_source_positions, params=n_params,
         dtype=cfg.dtype, moment_dtype="float32", seq=seq,
         global_batch=sz.whisper_train_batch,
         microbatches=sz.train_microbatches, remat=True,
         frame_embeddings="zeros (SyntheticLM)", init_seconds=init_s,
         steps=steps, mean_tokens_per_s_after_first=(
             sum(r["tokens_per_s"] for r in steps[1:]) / (len(steps) - 1)
             if len(steps) > 1 else None),
         max_memory_allocated=peak, launches=counts, parity=parity,
         profile=profile)
    del tr
    _free(dev)


# -------------------------------------------------------- phase: train_xlstm
XLSTM_PARITY_TOL = MLA_PARITY_TOL


def _xlstm_train_parity(dev, sz: Sizes, cfg) -> dict:
    """xLSTM-125M at published width cut to ``xlstm_parity_layers`` (an
    mLSTM layer, the sLSTM block, an mLSTM layer), float32, one sequence
    of ``xlstm_parity_seq``, remat: loss and every leaf's gradient of the
    port on the card against the same port on the CPU (the family has no
    kernel of this repo: the card runs cuBLAS and PyTorch's element-wise
    kernels).  Loss within 1e-5 relative, each gradient leaf finite and
    within 1e-4 x max|ref|."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import xlstm_model
    from repro_torch.training.trainer import (TrainConfig, make_loss_fn,
                                              value_and_grad)
    from repro_torch.tree import tree_leaves, tree_names

    pcfg = dataclasses.replace(cfg, n_layers=sz.xlstm_parity_layers,
                               slstm_at=(1,), dtype="float32")
    require([k for k, _, _ in xlstm_model.segments(pcfg)] == ["m", "s", "m"],
            "parity cut: m, s, m")
    params = xlstm_model.init_params(pcfg, 7, device=dev)
    tokens, labels = SyntheticLM(pcfg.vocab_size, sz.xlstm_parity_seq, 1,
                                 seed=7).batch_at(0)
    tok, lab = torch.from_numpy(tokens), torch.from_numpy(labels)
    loss_fn = make_loss_fn(pcfg, TrainConfig(remat=True))
    t0 = time.perf_counter()
    loss_k, g_k = value_and_grad(loss_fn, params, tok.to(dev), lab.to(dev))
    sync(dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_c, g_c = value_and_grad(loss_fn, _to(params, "cpu"), tok, lab)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
    require(math.isfinite(float(loss_k))
            and loss_rel <= XLSTM_PARITY_TOL["loss_rel"],
            f"train_xlstm parity: loss {float(loss_k)} vs {float(loss_c)}")
    grad_of_max = {}
    for n, a, b in zip(tree_names(g_k), tree_leaves(g_k), tree_leaves(g_c)):
        a = a.cpu()
        require(bool(torch.isfinite(a).all()), f"grad {n} not finite")
        grad_of_max[n] = float((a - b).abs().max()
                               / b.abs().max().clamp_min(1e-30))
    worst = max(grad_of_max, key=grad_of_max.get)
    require(grad_of_max[worst] <= XLSTM_PARITY_TOL["grad_of_max"],
            f"train_xlstm parity: grad {worst} max abs err "
            f"{grad_of_max[worst]} x max|ref|")
    del params, g_k, g_c
    return {"layers": pcfg.n_layers, "slstm_at": [1], "dtype": "float32",
            "seq": sz.xlstm_parity_seq, "loss_card": float(loss_k),
            "loss_cpu": float(loss_c), "loss_rel_err": loss_rel,
            "grad_err_of_max": grad_of_max, "worst_leaf": worst,
            "tolerance": XLSTM_PARITY_TOL, "card_seconds": card_s,
            "cpu_seconds": cpu_s}


def phase_train_xlstm(dev, sz: Sizes, table):
    """``make_train_step`` on xLSTM-125M at published width cut to
    ``xlstm_train_layers`` (an mLSTM layer and the sLSTM block; the step
    is host-bound and linear in depth), random bf16 weights from a seed,
    f32 moments: first the card-vs-CPU f32 parity, then
    ``xlstm_train_steps`` steps of tokens
    (``xlstm_train_batch``, ``xlstm_train_seq``) in one microbatch with
    remat (each mLSTM layer checkpointed, and inside it each 64-token
    chunk of the recurrences, without which autograd would keep the
    matrix memory of every token), counters zeroed just before the steps
    and read just after (no kernel of this repo on the path: each 0);
    finite losses and gradient norms; then one step at
    ``xlstm_profile_seq`` tokens under ``torch.profiler`` (host against
    device time, device launches a step)."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import xlstm_model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = _arch_config(sz, sz.xlstm_arch, n_layers=sz.xlstm_train_layers,
                       slstm_at=(sz.xlstm_train_layers - 1,))
    require(cfg.family == "xlstm", cfg.family)
    _free(dev)
    parity = _xlstm_train_parity(dev, sz, cfg)
    _free(dev)

    tcfg = TrainConfig(microbatches=1, remat=True,
                       optimizer=AdamWConfig(lr=3e-4, moment_dtype="float32"))
    B, S = sz.xlstm_train_batch, sz.xlstm_train_seq
    ds = SyntheticLM(cfg.vocab_size, S, B, seed=0)
    t0 = time.perf_counter()
    params = xlstm_model.init_params(cfg, 0, device=dev)
    opt_state = adamw.init(tcfg.optimizer, params)
    step_fn = make_train_step(cfg, tcfg)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    steps = []
    kernels.reset_launch_counts()
    for i in range(sz.xlstm_train_steps):
        tokens, labels = (torch.from_numpy(a).to(dev)
                          for a in ds.batch_at(i))
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, tokens,
                                             labels)
        sync(dev)
        wall = time.perf_counter() - t0
        steps.append({"step": i + 1, "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "wall_s": wall, "tokens_per_s": B * S / wall})
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in steps), f"train_xlstm: non-finite loss or "
            f"gradient: {steps}")
    require(not any(counts.values()), f"a kernel launched on a path "
            f"without attention: {counts}")

    short = SyntheticLM(cfg.vocab_size, sz.xlstm_profile_seq, B, seed=1)
    tk, lb = (torch.from_numpy(a).to(dev) for a in short.batch_at(0))

    def short_step():
        nonlocal params, opt_state
        params, opt_state, _ = step_fn(params, opt_state, tk, lb)

    profile = _profiled(dev, short_step, 1)
    emit("train_xlstm", arch=cfg.name, layers=cfg.n_layers,
         published_layers=_arch_config(sz, sz.xlstm_arch).n_layers,
         segments=xlstm_model.segments(cfg), d_model=cfg.d_model,
         heads=cfg.n_heads, vocab=cfg.vocab_size, params=n_params,
         dtype=cfg.dtype, moment_dtype="float32", seq=S, global_batch=B,
         microbatches=1, remat=True, recurrence_chunk=64,
         init_seconds=init_s, steps=steps,
         mean_tokens_per_s_after_first=(
             sum(r["tokens_per_s"] for r in steps[1:]) / (len(steps) - 1)
             if len(steps) > 1 else None),
         max_memory_allocated=peak, launches=counts,
         profiled_step={"seq": sz.xlstm_profile_seq, "batch": B, **profile},
         parity=parity)
    del params, opt_state
    _free(dev)


# ----------------------------------------------------------- phase: train_moe
MOE_PARITY_TOL = {"float32": {"loss_rel": 1e-5, "grad_of_max": 1e-4,
                               "top2_flip_share": 2e-2},
                  "bfloat16": {"loss_rel": 1e-2, "top2_flip_share": 2e-2,
                               "grad_rel_l2": "2 sqrt(2 f) + 2e-2"}}


def _flip_bound(flip: float) -> float:
    """A gradient leaf's relative L2 error allowed in bf16 when a share
    ``flip`` of the tokens changed their top-2 experts: each such token's
    contribution to a gradient (a sum over tokens) changes by about its own
    size, so the error grows as sqrt(2 f); twice that, plus 2e-2 for the
    bf16 roundings of the tokens that kept their experts."""
    return 2 * math.sqrt(2 * flip) + 2e-2


def _moe_train_parity(dev, sz: Sizes, cfg, dtype: str) -> dict:
    """One layer of ``cfg`` at published width in ``dtype``, one
    microbatch of the train shape (1 x ``train_seq``), remat: loss and
    every leaf's gradient by the kernel path against the plain path (flash
    attention's plain chunked version), both on the card.

    float32 (the CUDA-core route) is held as ``train_parity`` holds the
    dense model: loss within 1e-5 relative, each gradient leaf within 1e-4
    x max|ref|.  bfloat16 (the tensor-core route the training runs) rounds
    the two attention outputs differently, which can flip a router's top-2
    choice near a tie and so move that token's whole expert path: its loss
    is held to 1e-2 relative and each gradient leaf's relative L2 error to
    :func:`_flip_bound` of the share of tokens that flipped.  In both the
    share of tokens whose top-2 set differs is printed and held to 2 %."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decoder
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.attention_ops import flash_attention_xla
    from repro_torch.training.trainer import (TrainConfig, make_loss_fn,
                                              value_and_grad)
    from repro_torch.tree import tree_leaves, tree_names

    pcfg = dataclasses.replace(cfg, n_layers=1, dtype=dtype)
    params = decoder.init_params(pcfg, 7, device=dev)
    tokens, labels = SyntheticLM(pcfg.vocab_size, sz.train_seq, 1,
                                 seed=7).batch_at(0)
    tok = torch.from_numpy(tokens).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    router_in = []
    moe_group = moe_mod._moe_group

    def recording_group(p, c, xf, dropless):
        router_in.append(xf.detach())
        return moe_group(p, c, xf, dropless)

    loss_fn = make_loss_fn(pcfg, TrainConfig(remat=True))
    kernel_fn = attn_mod.flash_attention
    moe_mod._moe_group = recording_group
    try:
        before = kernels.launch_counts()
        loss_k, g_k = value_and_grad(loss_fn, params, tok, lab)
        sync(dev)
        after = kernels.launch_counts()
        x_k = router_in[0]
        router_in.clear()
        attn_mod.flash_attention = flash_attention_xla     # plain, on card
        loss_p, g_p = value_and_grad(loss_fn, params, tok, lab)
        sync(dev)
        x_p = router_in[0]
    finally:
        attn_mod.flash_attention = kernel_fn
        moe_mod._moe_group = moe_group
    fwd = after["flash_attention"] - before["flash_attention"]
    bwd = after["flash_attention_bwd"] - before["flash_attention_bwd"]
    require(dev.type != "cuda" or (fwd == 2 and bwd == 1),
            f"train_moe parity {dtype}: flash launches fwd {fwd} bwd {bwd}")
    router = params["moe_layers"]["moe"]["router"][0]
    k = pcfg.experts_per_token
    sel_k = torch.topk(x_k.float() @ router, k, dim=-1).indices.sort(-1)[0]
    sel_p = torch.topk(x_p.float() @ router, k, dim=-1).indices.sort(-1)[0]
    flip = float((sel_k != sel_p).any(-1).float().mean())
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_rel, grad_of_max = {}, {}
    for n, a, b in zip(tree_names(g_k), tree_leaves(g_k), tree_leaves(g_p)):
        a, b = a.float(), b.float()
        require(bool(torch.isfinite(a).all()), f"grad {n} not finite")
        grad_rel[n] = float((a - b).norm() / b.norm().clamp_min(1e-30))
        grad_of_max[n] = float((a - b).abs().max()
                               / b.abs().max().clamp_min(1e-30))
    tol = MOE_PARITY_TOL[dtype]
    require(math.isfinite(float(loss_k)) and loss_rel <= tol["loss_rel"],
            f"train_moe parity {dtype}: loss {float(loss_k)} vs "
            f"{float(loss_p)}")
    require(flip <= tol["top2_flip_share"], f"train_moe parity {dtype}: "
            f"top-2 differs for {flip} of the tokens")
    if "grad_of_max" in tol:
        worst = max(grad_of_max, key=grad_of_max.get)
        require(grad_of_max[worst] <= tol["grad_of_max"],
                f"train_moe parity {dtype}: grad {worst} max abs err "
                f"{grad_of_max[worst]} x max|ref|")
    else:
        worst = max(grad_rel, key=grad_rel.get)
        require(grad_rel[worst] <= _flip_bound(flip),
                f"train_moe parity {dtype}: grad {worst} relative L2 "
                f"{grad_rel[worst]} beyond {_flip_bound(flip)} with {flip} "
                f"of the tokens flipped")
    return {"dtype": dtype, "loss_kernel": float(loss_k),
            "loss_plain": float(loss_p), "loss_rel_err": loss_rel,
            "top2_differs_share": flip, "tokens": int(sel_k.shape[0]),
            "grad_err_of_max": grad_of_max, "grad_rel_l2": grad_rel,
            "tolerance": tol, "grad_rel_l2_limit": _flip_bound(flip),
            "flash_launches": {"fwd": fwd, "bwd": bwd}}


def _moe_layer_breakdown(dev, sz: Sizes, cfg, params, iters: int) -> dict:
    """The forward of one MoE layer (``moe._moe_group``) at one microbatch
    of the train shape, and its einsums alone on tensors of the same
    shapes: the dispatch einsum, the three expert-FFN einsums and the
    combine einsum; the rest of the layer (routing, the one-hot dispatch
    and combine tensors) is the difference.  Times are CUDA-event ms a
    call (the device is the limit at these sizes): in one run the
    profiler's kernel sums left out most of the FFN einsums' kernels."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe as moe_mod
    lp = {k: v[0] for k, v in params["moe_layers"]["moe"].items()}
    T, d = sz.train_seq * sz.train_batch // sz.train_microbatches, cfg.d_model
    E, f = cfg.n_experts, cfg.moe_d_ff
    C = moe_mod._capacity(T, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    xf = _rand(gen, (T, d), lp["wi"].dtype, dev)
    onehot = (torch.rand((T, E, C), generator=gen, device=dev)
              < 1.0 / T).to(xf.dtype)
    ein = _rand(gen, (E, C, d), xf.dtype, dev)
    eout = _rand(gen, (E, C, d), xf.dtype, dev)

    def ffn():
        h = F.silu(torch.einsum("ecd,edf->ecf", ein, lp["wi"])) \
            * torch.einsum("ecd,edf->ecf", ein, lp["wg"])
        return torch.einsum("ecf,efd->ecd", h, lp["wo"])

    def event_ms(fn):
        ms = time_ms(dev, [fn], iters)
        return EVENTS_MS[-1] if dev.type == "cuda" else ms

    with torch.no_grad():
        ms = {"layer": event_ms(lambda: moe_mod._moe_group(lp, cfg, xf,
                                                           False)),
              "dispatch_einsum": event_ms(lambda: torch.einsum(
                  "tec,td->ecd", onehot, xf)),
              "expert_ffn_einsums": event_ms(ffn),
              "combine_einsum": event_ms(lambda: torch.einsum(
                  "tec,ecd->td", onehot, eout))}
    ms["routing_and_rest"] = ms["layer"] - ms["dispatch_einsum"] \
        - ms["expert_ffn_einsums"] - ms["combine_einsum"]
    flops = {"dispatch_einsum": 2 * T * E * C * d,
             "expert_ffn_einsums": 3 * 2 * E * C * d * f,
             "combine_einsum": 2 * T * E * C * d}
    return {"tokens": T, "experts": E, "capacity": C, "timing": "CUDA events",
            "ms": ms,
            "share_of_layer": {n: v / ms["layer"] for n, v in ms.items()
                               if n != "layer"},
            "flops": flops,
            "tflops_per_s": {n: flops[n] / ms[n] / 1e9 for n in flops}}


def phase_train_moe(dev, sz: Sizes, table, with_profile: bool = False):
    """``Trainer`` on Mixtral-8x7B at published width, ``moe_layers`` deep:
    first the one-layer kernel-path / plain-path parity, then
    ``train_steps`` steps (counters zeroed just before, read just
    after), loss and aux loss each step; the state after step
    ``checkpoint_step`` is copied to the host and, after the last step,
    copied back into the trainer, whose next step must repeat that step's
    loss exactly.  Then one MoE layer's forward in its parts."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import decoder
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves

    cfg = _arch_config(sz, sz.moe_arch, n_layers=sz.moe_layers)
    require(cfg.family == "moe", cfg.family)
    parity = {"layers": 1, "seq": sz.train_seq}
    for dtype in ("float32", "bfloat16"):
        _free(dev)
        parity[dtype] = _moe_train_parity(dev, sz, cfg, dtype)
    _free(dev)

    tcfg = TrainConfig(microbatches=sz.train_microbatches, remat=True,
                       optimizer=AdamWConfig(lr=3e-4,
                                             moment_dtype="float32"))
    ds = SyntheticLM(cfg.vocab_size, sz.train_seq, sz.train_batch, seed=0)
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, 0, device=dev)
    tr = Trainer(cfg, tcfg, params, ds, device=dev)
    del params
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    tokens_per_step = sz.train_batch * sz.train_seq

    aux_seen = []
    forward = decoder.forward

    def recording_forward(*a, **kw):
        out = forward(*a, **kw)
        aux_seen.append(out[1].detach())
        return out

    def state():
        return tree_leaves(tr.params) + tree_leaves(tr.opt_state.mu) \
            + tree_leaves(tr.opt_state.nu) + [tr.opt_state.step]

    steps, snapshot, snap_s = [], None, None
    decoder.forward = recording_forward
    try:
        kernels.reset_launch_counts()
        for _ in range(sz.train_steps):
            t0 = time.perf_counter()
            tr.run(1, log_every=0)
            sync(dev)
            wall = time.perf_counter() - t0
            aux = sum(float(a) for a in aux_seen) / len(aux_seen)
            aux_seen.clear()
            steps.append(dict(tr.history[-1], aux=aux, wall_s=wall,
                              tokens_per_s=tokens_per_step / wall))
            if tr.step == sz.checkpoint_step:
                t0 = time.perf_counter()
                snapshot = [torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                        pin_memory=dev.type == "cuda")
                            .copy_(t) for t in state()]
                snap_s = time.perf_counter() - t0
        counts = _launches()
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        profile = _profiled(dev, lambda: tr.run(1, log_every=0), 1) \
            if with_profile else None
        t0 = time.perf_counter()
        for dst, src in zip(state(), snapshot):
            dst.copy_(src)
        sync(dev)
        restore_s = time.perf_counter() - t0
        del snapshot
        tr.step = sz.checkpoint_step
        tr.run(1, log_every=0)
        again = tr.history[-1]
    finally:
        decoder.forward = forward
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["aux"] > 0 for r in steps),
            f"train_moe: non-finite loss or no aux term: {steps}")
    per_step = sz.train_microbatches * sz.moe_layers
    require(dev.type != "cuda" or (
        counts["flash_attention"] == 2 * per_step * sz.train_steps
        and counts["flash_attention_bwd"] == per_step * sz.train_steps
        and counts["flash_wgmma_fwd"] == counts["flash_attention"]),
        f"flash launches on the train_moe path: {counts}")
    after_snap = steps[sz.checkpoint_step]
    diff = abs(again["loss"] - after_snap["loss"])
    require(diff <= 1e-6 * abs(after_snap["loss"]),
            f"loss after restore {again['loss']} != {after_snap['loss']}")
    breakdown = _moe_layer_breakdown(dev, sz, cfg, tr.params, 5)
    _add_launches(table, "train_moe", counts,
                  FLASH_TRAIN)
    emit("train_moe", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.head_dim, experts=cfg.n_experts,
         top_k=cfg.experts_per_token, moe_d_ff=cfg.moe_d_ff,
         window=cfg.sliding_window, vocab=cfg.vocab_size, params=n_params,
         dtype=cfg.dtype, moment_dtype="float32", seq=sz.train_seq,
         global_batch=sz.train_batch, microbatches=sz.train_microbatches,
         remat=True, init_seconds=init_s, steps=steps,
         mean_tokens_per_s_after_first=(
             sum(r["tokens_per_s"] for r in steps[1:]) / (len(steps) - 1)
             if len(steps) > 1 else None),
         max_memory_allocated=peak, launches=counts,
         snapshot={"step": sz.checkpoint_step, "to_host_seconds": snap_s,
                   "restore_seconds": restore_s,
                   "loss_step_after": after_snap["loss"],
                   "loss_step_after_restored": again["loss"],
                   "abs_diff": diff},
         parity=parity, moe_layer_forward=breakdown, profile=profile)
    del tr
    _free(dev)


# ------------------------------------------------------------ phase: profile
# the csrc/*.cu kernels, by the names the profiler gives them
PORT_KERNEL_NAMES = r"::(flash_|paged_attention_kernel|page_copy_kernel)"


def _profiled(dev, step, steps: int) -> dict:
    """Run ``step`` ``steps`` times unprofiled (host wall clock), then again
    under ``torch.profiler``: device time by kernel (the largest twelve, and
    the port's own kernels apart) and host time by op."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        sync(dev)
    rows = []                     # device kernels only, not the ops above them
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if dev_us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CUDA), reverse=True)
    return dict(
        steps=steps, wall_ms_per_step=wall_ms,
        device_ms_per_step=(total_us / 1e3 / steps) if rows
        else "not measured",
        device_busy_share=(total_us / 1e3 / steps / wall_ms) if rows
        else "not measured",
        device_launches_per_step=sum(r[1] for r in rows) / steps,
        top=[{"name": k[:80], "ms_per_step": us / 1e3 / steps,
              "calls_per_step": n / steps} for us, n, k in rows[:12]],
        port_kernels=[{"name": k[:80], "ms_per_step": us / 1e3 / steps,
                       "calls_per_step": n / steps} for us, n, k in rows
                      if re.search(PORT_KERNEL_NAMES, k)],
        host_ms_per_step_under_profiler=sum(h[0] for h in host) / 1e3 / steps,
        host_top=[{"name": k[:60], "self_ms_per_step": us / 1e3 / steps,
                   "calls_per_step": n / steps} for us, n, k in host[:14]])


def phase_profile(dev, sz: Sizes, cfg, params, steps: int = 4):
    """Optional (``--profile``): where one batch-1 decode step spends its
    time — host wall clock against summed device time, kernels by name."""
    emit("profile", layers=cfg.n_layers, batch=1,
         **_decode_profile(dev, sz, cfg, params, steps))


def _decode_profile(dev, sz: Sizes, cfg, params, steps: int,
                    max_len: int = 0) -> dict:
    """One batch-1 decode step at a third of ``max_len`` (by default the
    serve phases'; two steps first, unmeasured): :func:`_profiled`, and
    the context it ran at."""
    import torch
    from repro_torch.models.registry import model_for

    model = model_for(cfg)
    max_len = max_len or sz.pages_per_seq * cfg.kv_page_tokens
    cache = model.init_decode_cache(cfg, 1, max_len, device=dev)
    cache["lengths"] += max_len // 3
    tok = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    context = int(cache["lengths"][0]) + 2

    def step():
        nonlocal cache
        _, cache = model.decode_step(params, cfg, cache, tok)

    for _ in range(2):
        step()
    return dict(context=context, **_profiled(dev, step, steps))


# ----------------------------------------------------------------------- main
# --stop-after's choices, in the order of the phases they end after
# ------------------------------------------------------- phase: examples
#: the two stats lines of the reference's ``examples/serve_paged_kv.py``
#: (the JAX package's example, run on the CPU: ``PYTHONPATH=src python
#: examples/serve_paged_kv.py``); its twin prints the same
SERVE_EXAMPLE_STATS = (
    "touch_a_page  : 70 tokens, 42 decode steps, spills=6, fault_events=4, "
    "page-ins=4, simulated fault time=48.4us",
    "touch_ahead   : 70 tokens, 42 decode steps, spills=6, fault_events=4, "
    "page-ins=4, simulated fault time=36.0us")

#: runs an example script as ``__main__`` with its arguments, the launch
#: counters zeroed just before and printed (one JSON line) just after;
#: killed if the process that started it dies (``prctl(PR_SET_PDEATHSIG)``,
#: set here rather than in a ``preexec_fn``, which is unsafe in a process
#: with threads).  With ``--wait`` it first sets up what a training script
#: pays once (``torch._dynamo``, which ``torch.utils.checkpoint`` imports
#: on its first call, ``torch.distributed.tensor``, which the port's
#: DTensor checks import, the CUDA context) and then waits for ``go`` on
#: its standard input: a restart is started beside the run it resumes
#: from and let go when that run has ended
EXAMPLE_RUNNER = (
    "import ctypes, json, os, runpy, signal, sys\n"
    "ctypes.CDLL(None).prctl(1, signal.SIGKILL)\n"
    "if os.getppid() != int(sys.argv[1]):\n"
    "    sys.exit('chip_smoke.py is gone')\n"
    "from repro_torch import kernels\n"
    "if sys.argv[2] == '--wait':\n"
    "    import torch, torch._dynamo, torch.distributed.tensor\n"
    "    torch.zeros(1, device='cuda')\n"
    "    if sys.stdin.readline() != 'go\\n':\n"
    "        sys.exit('not let go')\n"
    "    del sys.argv[2]\n"
    "path = sys.argv[2]\n"
    "sys.argv = sys.argv[2:]\n"
    "kernels.reset_launch_counts()\n"
    "runpy.run_path(path, run_name='__main__')\n"
    "print('launches ' + json.dumps({**kernels.launch_counts(),\n"
    "                                **kernels.route_launch_counts()}),\n"
    "      flush=True)\n")


def _start_example(name: str, *args, wait: bool = False):
    """``examples/<name>`` in a subprocess on the card, its launches
    counted (``EXAMPLE_RUNNER``); with ``wait`` it waits after its set-up
    until :func:`_go`."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return subprocess.Popen(
        [sys.executable, "-c", EXAMPLE_RUNNER, str(os.getpid()),
         *(("--wait",) if wait else ()),
         os.path.join(root, "examples", name), *map(str, args)],
        cwd=root, env=env, stdin=subprocess.PIPE if wait else None,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _go(proc) -> None:
    """Let a waiting example's runner start its script."""
    proc.stdin.write("go\n")
    proc.stdin.flush()


def _finish_example(proc, what: str, timeout: float) -> tuple:
    """(the example's output lines, its launches by kernel); raises if it
    failed."""
    out, err = proc.communicate(timeout=timeout)
    require(proc.returncode == 0, f"examples: {what} exited "
            f"{proc.returncode}:\n{err[-3000:]}")
    lines = out.splitlines()
    require(lines and lines[-1].startswith("launches "),
            f"examples: {what} printed no launch counts")
    return lines[:-1], json.loads(lines[-1][len("launches "):])


def _train_losses(lines) -> dict:
    """step -> loss of the training twin's ``step N  loss X ...`` lines."""
    out = {}
    for ln in lines:
        m = re.match(r"step\s+(\d+)\s+loss\s+(\S+)\s", ln)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def phase_examples(dev, sz: Sizes, table) -> None:
    """The example twins on the card (a phase of the side process), each
    in a subprocess whose launch counters are zeroed just before the
    script runs and read just after: ``torch_serve_paged_kv.py`` at its
    defaults (the reference's scenario: its reduced H2O-Danube keeps a
    32-token window, so decode runs over a ring buffer and no kernel of
    ours) and with ``--window 0`` (the paged KV pools: paged attention and
    the page copies), each printing the reference's two stats lines
    (``SERVE_EXAMPLE_STATS``); and ``torch_train_demand_paged.py`` at its
    default size (52.4M f32 parameters: flash on its f32 route,
    ``PagedAdamW``'s page copies) for ``sz.example_train_steps`` steps
    with a checkpoint at the last, the three started together; then a
    restart of the training twin (started with them, let go when the
    first run has ended), which must resume from that checkpoint and take
    ``sz.example_resume_steps`` more.  Losses finite.  Credits
    the launches to ``table`` by path and emits the phase's line."""
    import shutil
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(root, "build", "examples_train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    n1 = sz.example_train_steps
    n2 = n1 + sz.example_resume_steps
    train = ("torch_train_demand_paged.py", "--log-every", 1,
             "--checkpoint-every", n1, "--checkpoint-dir", ckpt)
    t0 = time.perf_counter()
    procs = {"examples_serve": _start_example("torch_serve_paged_kv.py"),
             "examples_serve_paged": _start_example(
                 "torch_serve_paged_kv.py", "--window", 0),
             "examples_train": _start_example(*train, "--steps", n1),
             "examples_train_resume": _start_example(*train, "--steps", n2,
                                                     wait=True)}
    outs, ended = {}, {}
    try:
        outs["examples_train"] = _finish_example(
            procs["examples_train"], "the training twin", 600)
        ended["examples_train"] = time.perf_counter() - t0
        _go(procs["examples_train_resume"])
        for path in ("examples_serve", "examples_serve_paged",
                     "examples_train_resume"):
            outs[path] = _finish_example(procs[path], path, 600)
            ended[path] = time.perf_counter() - t0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for path in ("examples_serve", "examples_serve_paged"):
        stats = [ln for ln in outs[path][0] if ": " in ln and "tokens" in ln]
        require(tuple(stats) == SERVE_EXAMPLE_STATS, f"{path}: stats "
                f"{stats} differ from the reference's {SERVE_EXAMPLE_STATS}")
    first, resumed = (_train_losses(outs[p][0]) for p in
                      ("examples_train", "examples_train_resume"))
    require(sorted(first) == list(range(1, n1 + 1))
            and sorted(resumed) == list(range(n1 + 1, n2 + 1)),
            f"examples: logged steps {sorted(first)}, {sorted(resumed)}")
    require(all(math.isfinite(x) for x in (*first.values(),
                                           *resumed.values())),
            f"examples: losses {first} {resumed}")
    require(f"resumed from checkpoint at step {n1}"
            in outs["examples_train_resume"][0],
            "examples: the restart did not resume from its checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    launches = {p: o[1] for p, o in outs.items()}
    for path, want in (("examples_serve_paged", ("paged_attention",
                                                 "page_gather",
                                                 "page_scatter")),
                       ("examples_train", ("flash_attention",
                                           "flash_attention_bwd",
                                           "flash_f32_fwd", "flash_f32_bwd",
                                           "page_gather", "page_scatter")),
                       ("examples_train_resume", ("flash_attention",
                                                  "flash_attention_bwd",
                                                  "flash_f32_fwd",
                                                  "flash_f32_bwd"))):
        require(all(launches[path][k] > 0 for k in want),
                f"examples: {path} launches {launches[path]}")
    for path, counts in launches.items():
        _add_launches(table, path, counts, tuple(counts))
    emit("examples", seconds=secs, ended_at_seconds=ended,
         serve_stats=list(SERVE_EXAMPLE_STATS),
         train_losses={"first": first, "resumed": resumed},
         train_output={p: outs[p][0] for p in
                       ("examples_train", "examples_train_resume")},
         resumed_at=n1, launches=launches)


STOP_AFTER = ("profile", "kernels", "seq_split", "examples", "serve_xlstm", "train_xlstm",
              "remote_paging", "serve_hybrid_plain", "dist_families_side",
              "dist_local", "dist_step", "dist_families", "spill_parity",
              "serve", "serve_danube", "serve_hybrid", "serve_encdec",
              "serve_mla_moe", "train", "train_mla", "train_hybrid",
              "train_encdec")
# host-bound phases that time no kernel of this repo (the example twins'
# subprocesses; xLSTM's two, a Python loop over tokens; the remote-paging
# simulation, whose one-row copy timings are the exception; the hybrid's
# comparison with the plain path; three families' DTensor steps, which
# time nothing): they run in a second process on the same card (``--side``),
# started after the ``seq_split`` phase and waited for after
# ``serve_danube``; between the two the parent's phases time no kernel,
# and every phase after the wait runs alone
SIDE = ("examples", "serve_xlstm", "train_xlstm", "remote_paging",
        "serve_hybrid_plain", "dist_families_side")
SIDE_FNS = {"examples": phase_examples,
            "serve_xlstm": phase_serve_xlstm,
            "train_xlstm": phase_train_xlstm,
            "remote_paging": phase_remote_paging,
            "serve_hybrid_plain": phase_serve_hybrid_plain,
            "dist_families_side": phase_dist_families_side}


def run_side(dev, sz: Sizes, names) -> None:
    """The ``--side`` process: the phases ``names`` in order, crediting
    launches to rows of their own; the last line (``side_done``) gives
    each phase's seconds and its launches by kernel and path."""
    import torch
    from repro_torch import kernels
    torch.zeros(1, device=dev)    # the allocator's state, before _free
    rows = [{"name": n} for n in _launches()]
    secs = {}
    for name in names:
        t0 = time.perf_counter()
        SIDE_FNS[name](dev, sz, rows)
        secs[name] = time.perf_counter() - t0
    emit("side_done", seconds=secs,
         launches_by_path={r["name"]: r["launches_by_path"] for r in rows
                           if "launches_by_path" in r})


def _die_with_parent() -> None:
    """In the side process before it runs: the kernel kills it if the
    parent dies (Linux ``prctl(PR_SET_PDEATHSIG, SIGKILL)``)."""
    import ctypes
    import signal
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)


def _start_side(names):
    """Start ``chip_smoke.py --side names``; a thread collects its
    standard output (its standard error is the parent's)."""
    import threading
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--side", ",".join(names)],
                            stdout=subprocess.PIPE, text=True,
                            preexec_fn=_die_with_parent)
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout))
    reader.start()
    return proc, reader, lines


def _join_side(side, table, secs: dict) -> None:
    """Wait for the side process; raise if it failed.  Print its phases'
    lines, credit its launches to ``table`` and its phases' seconds to
    ``secs``."""
    proc, reader, lines = side
    rc = proc.wait()
    reader.join()
    require(rc == 0, f"the side phases failed (exit {rc}; their error is "
            "above)")
    done = [json.loads(ln) for ln in lines if '"side_done"' in ln]
    require(len(done) == 1, "the side process gave no side_done line")
    for ln in lines:
        if '"side_done"' not in ln:
            print(ln, end="", flush=True)
    for name, by in done[0]["launches_by_path"].items():
        for path, n in by.items():
            _add_launches(table, path, {name: n}, (name,))
    secs.update(done[0]["seconds"])


def run(dev, sz: Sizes, stop_after: str = "", with_profile: bool = False):
    """All phases after ``device``; returns the kernel table, or None when
    ``stop_after`` names an earlier phase (a partial run while debugging;
    ``STOP_AFTER`` gives the order, ``SIDE``'s phases in their second
    process).  Emits each phase's wall seconds at the end
    (``phase_seconds``: the side phases' overlap the parent's, ``total``
    sums them, ``wall_seconds`` is the run's own, ``side_wait`` the
    parent's wait for the side process)."""
    cfg = _arch_config(sz, sz.arch)
    secs: dict = {}
    t_run = time.perf_counter()
    side = table = None
    phase_fn = {"serve_danube": phase_serve_danube,
                "serve_hybrid": phase_serve_hybrid,
                "serve_encdec": phase_serve_encdec,
                "serve_mla_moe": phase_serve_mla_moe}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        if side is not None and side[0].poll() not in (None, 0):
            _join_side(side, table, secs)   # the side process failed: raise
        return out

    def reached(name) -> bool:
        return not stop_after or \
            STOP_AFTER.index(name) <= STOP_AFTER.index(stop_after)

    if stop_after == "profile":            # the profile alone, full depth
        from repro_torch.models import decoder
        timed("build", phase_build)
        phase_profile(dev, sz, cfg, decoder.init_params(cfg, 0, device=dev),
                      steps=8)
        return None
    emit("build", **timed("build", _build_fields))
    table = timed("kernels", phase_kernels, dev, sz, cfg)
    if reached("seq_split"):
        timed("seq_split", phase_seq_split, dev, sz, table)
    side_names = [n for n in SIDE if reached(n)]
    side = _start_side(side_names) if side_names else None
    try:
        if reached("dist_local"):
            timed("dist_local", phase_dist_local, dev, sz, cfg, table)
        if reached("dist_step"):
            timed("dist_step", phase_dist_step, dev, sz, table)
        if reached("dist_families"):
            timed("dist_families", phase_dist_families, dev, sz, table)
        if reached("spill_parity"):
            params, pcfg = timed("decode_parity", phase_decode_parity, dev,
                                 sz, cfg)
            timed("spill_parity", phase_spill_parity, dev, sz, pcfg, params)
            del params
        if reached("serve"):
            params, scfg = timed("serve", phase_serve, dev, sz, cfg, table)
            if with_profile:
                phase_profile(dev, sz, scfg, params, steps=8)
            del params
        if reached("serve_danube"):
            timed("serve_danube", phase_serve_danube, dev, sz, table)
        if side is not None:
            timed("side_wait", _join_side, side, table, secs)
            side = None
    finally:
        if side is not None:                # a parent phase failed
            side[0].kill()
            side[0].wait()
    for name in ("serve_hybrid", "serve_encdec", "serve_mla_moe"):
        if reached(name):
            timed(name, phase_fn[name], dev, sz, table)
    if reached("train"):
        timed("train_parity", phase_train_parity, dev, sz, cfg)
        timed("train", phase_train, dev, sz, cfg, table, with_profile)
    if reached("train_mla"):
        timed("train_mla", phase_train_mla, dev, sz, table)
    if reached("train_hybrid"):
        timed("train_hybrid", phase_train_hybrid, dev, sz, table)
    if reached("train_encdec"):
        timed("train_encdec", phase_train_encdec, dev, sz, table,
              with_profile)
    if not stop_after:
        timed("train_moe", phase_train_moe, dev, sz, table, with_profile)
    emit("phase_seconds", seconds=secs, total=sum(secs.values()),
         wall_seconds=time.perf_counter() - t_run, side_process=side_names)
    return None if stop_after else table


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this run needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    dev = torch.device("cuda", 0)
    # full f32 products in every comparison (PyTorch's defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stop-after", default="",
                    choices=("",) + STOP_AFTER,
                    help="partial run for debugging; prints no result line")
    ap.add_argument("--profile", action="store_true",
                    help="after serve, profile a batch-1 decode step; after "
                         "train, train_encdec and train_moe, one training "
                         "step")
    ap.add_argument("--side", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:                         # the second process of run()
        run_side(dev, Sizes(), args.side.split(","))
        return 0
    smi = phase_device(dev)
    table = run(dev, Sizes(), args.stop_after, args.profile)
    if table is None:
        return 0
    for row in table:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            require(math.isfinite(row[key]), f"{row['name']}: {key}")
        require(row["launches"] > 0, f"{row['name']} never launched on "
                "a path")
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
