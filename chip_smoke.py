#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc
(one nvcc per source, all started together) and drives two paths:

* serving: holds the Huffman-decode and GQA paged-attention kernels (fp
  and int8 codec pools; split TF32 on tensor cores; their registers,
  spills and shared memory, TF32 and f32 bounds, event and device times
  beside SDPA's) against their plain PyTorch versions at serving shapes,
  serves minitron-8b at its published widths (depth cut to 1 layer)
  through ``ServeEngine`` and ``Scheduler`` on the ``cuda_paged``
  backend, with fp pools and again with ``kv_codec="cluster"`` (int8 code
  pools decoded in the kernel), and checks that the kernels were launched
  by those runs, that every request completed, that a second run gives
  the same tokens, and that ``WeightStore.fused_operands`` on a
  full-width MLP matrix gives the materialised weights' binary product;
* telemetry and ``--cache-mb auto``: the minitron main path serves the
  same requests from a cold tile cache with ``Telemetry(trace=True)``
  (tokens and launches those of the untraced run; the Chrome trace, its
  JSONL and the Prometheus text written, reloaded and checked against the
  counters; phase histograms printed, with warm ms/step with telemetry off
  and on and the device busy of a profiled traced run), then at the
  decode-cache capacity ``recommend_store_capacity`` picks (the sweep's
  seconds, knee and projected hit rate printed; tokens those of the
  unbounded run);
* MLA: holds the MLA paged-attention kernel (one 512-wide latent head
  that is key and value, a 64-wide rope operand, 128 query heads; fp and
  codec pools; split TF32 on tensor cores) against its plain version, then
  serves deepseek-v2-236b at its published widths (depth cut to 2 layers,
  one dense-MLP and one MoE block) the same way, with fp pools and with
  the codec; a small minitron and a small deepseek served on the card
  give the CPU's tokens, with and without the codec;
* the gathered backend, monolithic prefill, monolithic lanes and wave
  mode: the full-width minitron serves the same requests along each
  (gathered with page 16, monolithic prefill installed into the pages
  and decoded on the attention kernel at Q=1, one lane a slot, wave
  admission, the gathered codec), and the deepseek the first two, each
  from a cold tile cache with its launches and copied bytes checked and a
  warm run profiled; at both models' full widths (bf16 MLPs left
  uncompressed), one decode step's logits after monolithic prefill agree
  bit for bit between monolithic lanes and gathered pages, and between
  the kernel path and the gathered one within a bound set by one bf16 ulp
  on the cached K/V, which a planted one-row page shift must break;
  ``paged_decode_attention`` (Q=1) is held against its plain version at
  both models' widths; the small models give the CPU's tokens on every
  one of these paths;
* phi3-medium-14b, h2o-danube-1.8b, gemma2-2b and mixtral-8x22b: holds
  the GQA kernel against its plain version at each arch's heads and
  head_dim (bf16 and codec pools, Q=64 and Q=1; registers, spills and
  shared memory, bounds, event and device times beside SDPA's), serves
  each at its published widths (depth cut: ``ARCH_LAYERS``) on the main
  path with the attention launches counted against the kernel backend's
  steps, serves gemma2 and danube again with the window cut to
  ``WINDOW_CUT`` (gemma2's local blocks and every danube block then keep
  rolling lanes: the kernel runs for gemma2's global block alone, and
  never for danube), compares one decode step's logits of the kernel
  path with the gathered one for each (and gemma2 at the cut window), and
  serves each tiny config (gemma2 also at window 16) on card and CPU to
  the same tokens;
* prefix sharing and speculative decoding: the GQA and MLA kernels on
  verify blocks (Q=5 ragged, blocks across page boundaries, two slots'
  tables mapping the same physical pages; the GQA kernel's 16-, 32- and
  64-row blocks as S grows) against their plain versions; the full-width
  minitron serves requests sharing a 128-token prefix with sharing off,
  with sharing, and with sharing plus n-gram and draft-model speculation
  (deepseek the last three, gemma2 at the cut window the speculative two
  beside its rolling lanes), each from a cold tile cache with prefix
  hits, reused tokens, skipped chunks and copies on write checked against
  what the prompts and the chunk floor predict, the pool drained to the
  index's references, launches = kernel-backend steps x pooled blocks,
  steps by width, drafts and acceptance printed, and a warm run
  profiled; at both models' widths (uncompressed bf16 MLPs) a Q=5 block
  scored in one mixed step against five Q=1 steps, and a slot on mapped
  prefix pages against one that computed them, within the ulp floor of
  the logits check, which a planted one-row page shift must break; the
  small models give the CPU's tokens and counters on ``SHARED_PATHS``;
* mamba2-780m, recurrentgemma-2b, paligemma-3b and whisper-large-v3:
  holds the GQA kernel against its plain version at paligemma's decode
  shape (8 query heads over one KV head of 256, Q=1, bf16 and codec
  pools), serves each at its published widths (depth cut:
  ``STATE_ARCH_LAYERS``) asked for the main path and downgraded as the
  reference downgrades it (the recurrent archs and whisper to the
  gathered backend, paligemma and whisper to monolithic prefill; the
  notes printed), checks the Huffman decode's launches and every
  compressed matrix shape bit for bit, paligemma's attention launches
  against its decode steps, a second run's tokens and n-gram
  speculation's on the recurrent archs (which must propose drafts;
  mamba2's in f32, with draft-model speculation beside it:
  ``SPEC_F32_LAYERS``), profiles one warm batch, and serves each tiny
  config on card and CPU to the same tokens;
* the paper's BNN: times the int8 and binary mma.sync probe, prints the
  fused and contraction kernels' registers, spills, shared memory and
  launch plans, holds the binarize-pack ((M, K) rows and 3x3 patches
  straight from NHWC), xnor-popcount contraction and fused Huffman-decode
  kernels (both contractions on the binary tensor cores) against their
  plain versions bit for bit at every ReActNet-A block shape at batch 32
  (and ragged shapes; the patches also against im2col + binarize-pack,
  timed beside them; the contraction's 3x3 and 1x1 shapes timed apart),
  then
  classifies 32 images of 224x224 through ReActNet-A at
  full width in ``ste``, ``packed`` and ``compressed`` conv modes,
  checks identical logits and each kernel's launches, profiles the
  packed and compressed forwards, and checks a small ReActNet's logits on
  card and CPU;
* the paper's BNN workflow: ReActNet-A at its published shapes trains a
  few steps with the STE (``loss_and_grads`` and the port's AdamW;
  losses, gradients and leaves finite and clipped, BN running stats
  moved by weight decay alone; ms/step by events, a profiled step's
  device busy, peak memory), its trained weights are compressed and
  deployed in the three conv modes with identical logits and each
  kernel's launches, and one step of a small model is held card against
  CPU; then ``examples/torch_train_reactnet.py``'s workflow trains on the
  card, deploys through the kernels (launches counted), meets the
  reference workflow's assertions (``tests/test_system.py::
  TestPaperWorkflow``) and writes a compressed checkpoint, which is
  restored and redeployed to the same predictions;
* the LM trainer (run last, on a world of one rank: NCCL for the card's
  tensors, gloo for the CPU's): gemma2-2b at its published widths and
  full depth (26 layers, bf16, remat) trains a few steps of
  ``build_train_step`` on ``SyntheticLM`` (finite losses, ms/step by
  events, peak memory, a profiled step's device busy and top kernels,
  beside the step's bf16 floor from ``lm_train_bound``); the tiny gemma2
  takes one step on card and CPU to the same loss, gradients and
  params, the launcher's supervised run killed after a checkpoint
  resumes to the unbroken run's losses, a bf16 state checkpointed by
  the Supervisor restores bit for bit, and the 1-bit and int8
  compressed DP step over NCCL equals gloo on the CPU.

Each phase prints its seconds.  The last two lines of standard output
are one JSON object per kernel (``{"kernels": [...]}``; the GQA kernel at
each new arch's shapes is an entry of its own) and ``{"ok": true,
"device": {...}}``.  Any
failure exits non-zero before them, as does a machine without a GPU.
Peak rates for the roofline bounds are the H100 SXM data-sheet numbers,
and for binary MMAs 8x the int8 one (``B1_TC_OPS_PER_S``).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "examples"))

import torch_train_reactnet as train_example  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    bitpack, clustering, compression, frequency, huffman)
from repro_torch.data.pipeline import (  # noqa: E402
    SyntheticImages, SyntheticLM)
from repro_torch.kernels import _build, kv_codec, ops, ref  # noqa: E402
from repro_torch.kernels.binarize_pack import (  # noqa: E402
    binarize_pack, binarize_pack_patches)
from repro_torch.kernels.binary_contraction import (  # noqa: E402
    binary_contraction, contraction_kernel_info, contraction_plan)
from repro_torch.kernels.fused_decode_contraction import (  # noqa: E402
    fused_decode_matmul, fused_kernel_info, fused_plan, mma_rate)
from repro_torch.kernels.huffman_decode import (  # noqa: E402
    flat_table, huffman_decode, pack_bitplane_tables)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    decode_pool, gqa_kernel_info, mla_kernel_info, paged_decode_attention,
    paged_mixed_attention, paged_mixed_attention_plain, sm_count)
from repro_torch.dist.compression_comm import (  # noqa: E402
    init_error_feedback)
from repro_torch.dist.fault import FaultConfig, Supervisor  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    TOO_DEEP_FOR_ONE_CARD, codec_report, cut_depth, init_params, tiny_config)
from repro_torch.launch.train import to_batch  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models import reactnet as rn  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    NULL_TELEMETRY, Request, Scheduler, ServeEngine, ServeMetrics, SlotPool,
    Telemetry, parse_prom, recommend_store_capacity)
from repro_torch.runtime import scheduler as sched_mod  # noqa: E402
from repro_torch.runtime.drafter import (  # noqa: E402
    DraftModelDrafter, draft_config)
from repro_torch.runtime.scheduler import SLOT_LEN_QUANTUM  # noqa: E402
from repro_torch.runtime.telemetry import (  # noqa: E402
    PID_ENGINE, PID_REQUEST)
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.tree import (  # noqa: E402
    tree_leaves, tree_map, tree_map_with_path)
from profile_reactnet import SESSIONS, profile_forward  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_OPS_PER_S = 67e12            # H100 SXM CUDA cores, an FMA counted as 2
TF32_OPS_PER_S = 495e12          # H100 SXM tensor cores, TF32 dense
# int32 issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost, one op per
# lane per clock -- a quarter of the f32 rate (half the lanes, no FMA pair)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# __popc issue rate: 16 per SM per clock on compute capability 9.0 (the
# CUDA C++ Programming Guide's arithmetic-instruction throughput table), a
# quarter of the int32 rate: 132 SMs x 16 x 1.98 GHz boost
POPC_OPS_PER_S = 132 * 16 * 1.98e9
INT8_TC_OPS_PER_S = 1979e12      # H100 SXM tensor cores, int8 dense (a
#                                  multiply-accumulate counted as 2)
# binary (b1 .and.popc) tensor-core rate: not on the data sheet; the
# m16n8k256 b1 MMA issues at the s8 m16n8k32 one's rate with 8x its k
# (``_fused_info``'s probe on the H100: 8.06x the s8 ops rate), so 8x the
# int8 dense peak
B1_TC_OPS_PER_S = 8 * INT8_TC_OPS_PER_S
DECODE_OPS_PER_CODE = 25         # integer ops per decoded code (see .cuh)
ATTN_TOL = 1e-4                  # kernel vs plain, bf16 pools: both score
#                                  in f32 from the same bf16 values, so they
#                                  differ in f32 summation order and the
#                                  exp/tanh implementations only
# first decode step's logits after a monolithic prefill, the kernel path
# against the gathered one: they may differ by at most this many times what
# flipping the last bit of every cached bf16 K/V value (one bf16 ulp) moves
# the gathered path's logits -- the kernel reads the same bf16 values and
# differs from the plain attention in f32 rounding only
LOGIT_ULP_FACTOR = 4
ATTN_SOFTCAP = 4.0               # near the score scale, so a kernel that
#                                  skipped the cap would fail the check

# serve phase: minitron-8b widths, depth cut to one block for host-side
# compression and the script's time limit (its serve phases run many paths)
SERVE_LAYERS = 1
SERVE_BATCH, SERVE_CHUNK, SERVE_PAGE, SERVE_GEN = 4, 64, 16, 16
SERVE_PROMPTS = np.linspace(32, 256, 8).astype(int)

# MLA phases: deepseek-v2-236b widths, depth cut to one block of each kind
MLA_ARCH, MLA_LAYERS = "deepseek-v2-236b", 2
MLA_HEADS, MLA_LATENT, MLA_ROPE = 128, 512, 64
MLA_SCALE = (128 + 64) ** -0.5      # (nope + rope head dims) ** -0.5
SMALL_MLA = dict(   # the reduced deepseek of the JAX package's tests
    num_layers=3, prefix_kinds=("mla_dense",), scan_repeats=2, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, moe_d_ff=32,
    num_experts=4, num_shared_experts=1, top_k=2, kv_lora_rank=16,
    q_lora_rank=24, rope_head_dim=8, nope_head_dim=16, v_head_dim=16,
    capacity_factor=8.0)

# the archs served on both backends beside minitron and deepseek: depth cut
# to these many layers (published widths), and why
ARCH_LAYERS = {
    "phi3-medium-14b": (1, "registration binarises and Huffman-compresses "
                           "each 5120x17920 MLP matrix on the host, 120 at "
                           "full depth; one block runs every module"),
    "h2o-danube-1.8b": (2, "registration compresses each 2560x6912 MLP "
                           "matrix on the host, 72 at full depth"),
    "gemma2-2b": (2, "one repeat of its local + global pattern runs every "
                     "module; registration compresses each 2304x9216 MLP "
                     "matrix on the host, 78 at full depth"),
    "mixtral-8x22b": (2, "does not fit one card: "
                         + TOO_DEEP_FOR_ONE_CARD["mixtral-8x22b"]),
}
# the archs with recurrent state or a multimodal prefix, served beside the
# others: depth cut to these many layers (published widths), and why
STATE_ARCH_LAYERS = {
    "mamba2-780m": (16, "one block kind, so 16 of the 48 run every module; "
                        "its serve runs and profile a third as long"),
    "recurrentgemma-2b": (5, "one (rglru, rglru, attn_local) repeat and its "
                             "two suffix rglru blocks run every module; "
                             "registration compresses each 2560x7680 MLP "
                             "matrix on the host, 78 at full depth"),
    "paligemma-3b": (2, "registration compresses each 2048x16384 MLP "
                        "matrix on the host, 54 at full depth"),
    "whisper-large-v3": (2, "2 encoder + 2 decoder layers run every module; "
                            "registration compresses each 1280x5120 MLP "
                            "matrix on the host, 128 at full depth"),
}
# the recurrent archs whose speculation is held in f32 (TF32 off) at
# published widths, depth cut to these many layers, and not in bf16: their
# bf16 verify block and one-token update round differently, and greedy
# ties between bf16 logits then break either way (ROADMAP Queue 3)
SPEC_F32_LAYERS = {"mamba2-780m": 16}
# the paths their tiny configs serve on card and CPU: what each asks for
# that the arch lacks is downgraded on both devices alike (the codec is
# left out: the encoder-decoder has no codec path, in the reference too)
STATE_SMALL_PATHS = (
    dict(attn_backend="gathered"),
    dict(prefill_chunk=3, kv_page_size=4),
    dict(mode="wave", attn_backend="gathered"),
    dict(attn_backend="gathered", kv_page_size=4, speculate="ngram"),
)

# the window the lane checks cut to: shorter than the serve phases' slots
# (up to 272 positions), so a windowed block's K/V are rolling lanes
WINDOW_CUT = 64

# prefix sharing and speculation at full width: the serve phases' prompts
# share their first PREFIX_LEN tokens (each keeps its last one its own);
# the speculative run drafts DRAFT_K tokens from n-grams of prompts whose
# tails repeat PATTERN-token patterns; PREFIX_PAGES backs every slot and
# the index's pages, so the index never evicts
PREFIX_LEN, DRAFT_K, PATTERN, PREFIX_PAGES = 128, 4, 8, 160

# ReActNet-A phase: the full model at its published shapes
RN_BATCH = 32
RN_TOL = 1e-4                    # small model, card vs CPU: with exact
#                                  params only the head's dot differs
EXACT_VAR = 1.0 - 1e-5           # float32(var) + 1e-5 == 1.0: BN identity

# ReActNet-A training: the example's optimizer for a few steps in ste mode
RN_TRAIN_STEPS = 8
RN_TRAIN_OC = train_example.opt_config(RN_TRAIN_STEPS)
# one training step of the small model, card vs CPU with exact params: the
# loss and each gradient leaf within TRAIN_TOL x the leaf's largest
# element (the CPU tests hold the port to the reference at this bound)
TRAIN_TOL = 1e-4
# the paper's workflow: the example trained on the card for this many steps
PAPER_STEPS = 150


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call: the CUDA kernels' own time under
    torch.profiler, without the host time between launches that
    ``time_ms`` also counts when a call is short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a profiling session now and then sees nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total:
            return total / 1e3 / iters
    fail("the profiler saw no CUDA kernel time in three sessions")


def graph_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``iters`` calls: the kernels' own time, without the wrapper's host
    time between launches that ``time_ms`` counts when a call is short
    (and without the profiler, which now and then loses short kernels)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def phase_build() -> None:
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1] if nvcc else 'no version output'}")
    t0 = time.monotonic()
    secs = _build.build()
    print(f"build: {', '.join(f'{k} {v:.1f}s' for k, v in secs.items())} "
          f"(wall {time.monotonic() - t0:.1f}s, nvcc in parallel)")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def phase_register(dev):
    cfg = get_config("minitron-8b").scaled(num_layers=SERVE_LAYERS,
                                           scan_repeats=SERVE_LAYERS)
    print(f"reduced: minitron-8b depth 32 -> {SERVE_LAYERS} layers "
          f"(widths as published: d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}); reason: "
          f"registration binarises and Huffman-compresses every "
          f"{cfg.d_model}x{cfg.d_ff} MLP matrix on the host (~7 s each), "
          f"and full depth has {3 * 32} of them; one block runs every "
          f"module, and the serve phases that follow run many paths "
          f"within the script's time limit")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    up0 = params["scan"]["b0"]["mlp"]["up"][0].float().cpu().numpy()
    expect = bitpack.gemm_to_sequences((up0.T >= 0).astype(np.uint8))
    t0 = time.monotonic()
    engine = ServeEngine(cfg, params, device=dev)
    reg_s = time.monotonic() - t0
    rep = engine.report
    print(f"registration: {rep['layers']} MLP matrices in {reg_s:.1f}s, "
          f"{rep['packed_bytes']} packed -> {rep['stream_bytes']} stream "
          f"bytes ({rep['ratio_stream']:.3f}x)")
    return engine, expect


def phase_huffman(engine, expect) -> dict:
    layer = engine.store.layers(engine.model_id)["scan/b0/mlp/up"][0]
    words, tables, c = layer.words, layer.tables, layer.tiled.c
    got = huffman_decode(words, tables, c=c)
    plain = ref.decode_tiled(words, tables, c)
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        fail(f"huffman_decode differs from its plain version at "
             f"{int((got != plain).sum())} of {got.numel()} codes")
    seqs = ref.tiled_to_sequences(got, layer.ct.n_seqs).cpu().numpy()
    if not np.array_equal(seqs, expect.ravel().astype(np.int32)):
        fail("decoded sequences differ from the registered weights' bits")
    ms = time_ms(lambda: huffman_decode(words, tables, c=c), iters=50)
    g_ms = graph_ms(lambda: huffman_decode(words, tables, c=c))
    d_ms = device_ms(lambda: huffman_decode(words, tables, c=c))
    plain_ms = time_ms(lambda: ref.decode_tiled(words, tables, c), iters=5)
    nbytes = words.numel() * 4 + tables.numel() * 4 + got.numel() * 4
    bms, by = bound_ms(nbytes, DECODE_OPS_PER_CODE * got.numel(),
                       INT32_OPS_PER_S)
    t, w, s = words.shape
    print(f"huffman_decode: (T={t}, W={w}, S={s}) -> C={c}, one full-width "
          f"matrix ({layer.n}x{layer.k} bits); bit-exact vs plain and vs "
          f"the registered bits; kernel {ms:.4f} ms (graph {g_ms:.4f}, "
          f"device {d_ms:.4f}), plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}; device time {d_ms / bms:.2f}x it)")
    return {"name": "huffman_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/huffman_decode.cu",
            "replaces": "src/repro/kernels/huffman_decode.py:112",
            "max_abs_err": 0.0, "ms": ms, "graph_ms": g_ms,
            "device_ms": d_ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"T={t} W={w} S={s} C={c}"}


def _attn_inputs(dev, qn, q_lens, lengths, pps, gen, h=32, kh=8, d=128,
                 s_n=SERVE_BATCH, shared=False):
    """Ragged kernel inputs over random bf16 pools (S = ``s_n``);
    ``shared``: slot 3's first two logical pages map slot 1's physical
    pages, as two tables do that map one cached prefix."""
    page = SERVE_PAGE
    n_pages = s_n * pps + 1
    k = torch.randn((n_pages, page, kh, d), generator=gen, device=dev)
    v = torch.randn((n_pages, page, kh, d), generator=gen, device=dev)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table = perm.reshape(s_n, pps).to(torch.int32)
    # as in SlotPool: logical pages past a slot's length map to the page-0
    # dummy sink
    owned = -(-torch.tensor(lengths, device=dev) // page)
    table[torch.arange(pps, device=dev)[None] >= owned[:, None]] = 0
    if shared:
        table[3, :2] = table[1, :2]
    q = torch.randn((s_n, qn, h, d), generator=gen, device=dev) * d ** -0.5
    as_i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    return q, k, v, table, as_i32(lengths), as_i32(q_lens)


def _attn_bytes_ops(q, k, table, lengths, q_lens, window, codec=False,
                    q2=None, k2=None, shared_kv=False):
    """Bytes every input read once + output written once, and f32 ops,
    for what these inputs need (positions each slot's tokens can see;
    query rows of real tokens only, since rows ``i >= q_lens`` are never
    read, while the whole output is written, its padding rows as zeros).
    ``codec``: ``k`` holds int8 codes, each visible (position, head, dim)
    element decoded once (one multiply), plus one f32 scale per visible
    position in each scale pool.  MLA: ``q2``/``k2`` add the second score
    operand (its bytes, its scale pool, 2 ops per element of ``q2 . k2``),
    and ``shared_kv`` counts the one latent pool that is both K and V
    once."""
    _, qn, h, d = q.shape
    kh = k.shape[2]
    d2 = 0 if k2 is None else k2.shape[-1]
    width = (1 if shared_kv else 2) * d + d2    # pool elements a position
    n_scales = (1 if shared_kv else 2) + (k2 is not None)
    kv_pos, pairs = 0, 0
    for ln, ql in zip(lengths.tolist(), q_lens.tolist()):
        if not ql:
            continue
        first = ln - ql
        lo = max(0, first - window + 1) if window else 0
        kv_pos += ln - lo
        for i in range(ql):
            qp = first + i
            pairs += qp + 1 - (max(0, qp - window + 1) if window else 0)
    tokens = int(q_lens.sum())
    nbytes = (tokens * h * (d + d2) * 4
              + kv_pos * kh * width * k.element_size()
              + table.numel() * 4 + 2 * lengths.numel() * 4 + q.numel() * 4)
    # q.k, q2.k2, p.v, online-softmax update
    ops = pairs * h * (4 * d + 2 * d2 + 6)
    if codec:
        nbytes += kv_pos * n_scales * 4 + kv_codec.LEVELS * 4
        ops += kv_pos * kh * width
    return nbytes, ops


def _sdpa(q, k, v, table, lengths, q_lens, scale=1.0):
    """One torch SDPA call over the gathered per-slot view, ready to time
    (yardstick only; the port never calls it)."""
    import torch.nn.functional as F
    s_n, qn, h, d = q.shape
    kh = k.shape[2]
    span = table.shape[1] * k.shape[1]
    kg = k[table.long()].reshape(s_n, span, kh, d).repeat_interleave(
        h // kh, dim=2).transpose(1, 2)
    vg = v[table.long()].reshape(s_n, span, kh, -1).repeat_interleave(
        h // kh, dim=2).transpose(1, 2)
    qg = q.to(k.dtype).transpose(1, 2)
    qpos = (lengths - q_lens)[:, None] + torch.arange(qn, device=q.device)
    mask = torch.arange(span, device=q.device)[None, None] <= qpos[..., None]
    mask = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                  scale=scale)


def _sdpa_ms(q, k, v, table, lengths, q_lens, scale=1.0) -> float:
    return time_ms(_sdpa(q, k, v, table, lengths, q_lens, scale), iters=50)


def _codec_attention(q, k, v, table, ln, ql, qn, dev) -> tuple:
    """The codec case at one serve shape: ``k``/``v`` (bf16) encoded as
    the serve path encodes them; the codec kernel against its plain
    version (ATTN_TOL), bit for bit against the fp kernel on the pools
    decoded up front into f32 under both dequant names, and with poisoned
    page-0 codes -> (worst error, timing)."""
    (kc, ks), (vc, vs) = (kv_codec.encode(x, (-2, -1)) for x in (k, v))
    cb = kv_codec.codebook(dev)
    kd, vd = decode_pool(kc, ks, cb), decode_pool(vc, vs, cb)
    worst = 0.0
    rows = torch.arange(qn, device=dev)[None] < ql[:, None]
    for window in (0, 100):
        for cap in (0.0, ATTN_SOFTCAP):
            kw = dict(window=window, softcap_val=cap, page_size=SERVE_PAGE)
            ckw = dict(k_scales=ks, v_scales=vs, codebook=cb, **kw)
            fp = paged_mixed_attention(q, kd, vd, table, ln, ql, **kw)
            want = paged_mixed_attention_plain(q, kc, vc, table, ln, ql, ks,
                                               vs, cb, **kw)
            got = {d: paged_mixed_attention(q, kc, vc, table, ln, ql,
                                            dequant=d, **ckw)
                   for d in ("gather", "onehot")}
            kp, vp = kc.clone(), vc.clone()
            kp[0], vp[0] = 127, -127
            poisoned = paged_mixed_attention(q, kp, vp, table, ln, ql, **ckw)
            torch.cuda.synchronize()
            err = float((got["gather"] - want).abs()[rows].max())
            worst = max(worst, err)
            if not torch.isfinite(got["gather"]).all() or err > ATTN_TOL:
                fail(f"codec paged attention Q={qn} window={window} "
                     f"softcap={cap}: max err {err} > {ATTN_TOL}")
            for d, out in got.items():
                if not torch.equal(out, fp):
                    fail(f"codec kernel ({d}) Q={qn} window={window} "
                         f"softcap={cap} differs from the fp kernel on the "
                         f"decoded f32 pool at "
                         f"{int((out != fp).sum())} outputs")
            if not torch.equal(got["gather"], poisoned):
                fail("poisoned page-0 codes changed the codec kernel's "
                     "output")
    kw = dict(k_scales=ks, v_scales=vs, codebook=cb, page_size=SERVE_PAGE)
    ms = time_ms(lambda: paged_mixed_attention(q, kc, vc, table, ln, ql,
                                               **kw), iters=50)
    onehot_ms = time_ms(lambda: paged_mixed_attention(
        q, kc, vc, table, ln, ql, dequant="onehot", **kw), iters=5)
    plain_ms = time_ms(lambda: paged_mixed_attention_plain(
        q, kc, vc, table, ln, ql, ks, vs, cb, page_size=SERVE_PAGE),
        iters=10)
    decode_ms = time_ms(lambda: (decode_pool(kc, ks, cb),
                                 decode_pool(vc, vs, cb)), iters=20)
    lib_ms = _sdpa_ms(q, kd, vd, table, ln, ql)
    dev_ms = device_ms(lambda: paged_mixed_attention(q, kc, vc, table, ln, ql,
                                                     **kw))
    lib_dev_ms = device_ms(_sdpa(q, kd, vd, table, ln, ql))
    nbytes, ops = _attn_bytes_ops(q, kc, table, ln, ql, 0, codec=True)
    bms, by, f32_bms = _attn_bounds("codec", qn, nbytes, ops)
    return worst, (ms, plain_ms, lib_ms, bms, by, decode_ms, onehot_ms,
                   f32_bms, dev_ms, lib_dev_ms)


def _attn_bounds(label, qn, nbytes, ops) -> tuple:
    """Print and return the attention kernel's bound at the TF32
    tensor-core rate (where its products run; the split's extra MMAs are
    the kernel's cost, not the function's) and at the f32 CUDA-core rate
    -> (TF32 bound ms, what sets it, f32 bound ms)."""
    bms, by = bound_ms(nbytes, ops, ops_per_s=TF32_OPS_PER_S)
    f32_bms, _ = bound_ms(nbytes, ops)
    print(f"  {label} Q={qn} bounds: bytes "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} B), operations "
          f"{ops / TF32_OPS_PER_S * 1e3:.4f} ms at the TF32 tensor-core rate,"
          f" {ops / F32_OPS_PER_S * 1e3:.4f} ms at the f32 CUDA-core rate "
          f"({ops} ops): bound {bms:.4f} ms (TF32, {by}), {f32_bms:.4f} ms "
          f"(f32)")
    return bms, by, f32_bms


def phase_attention(dev) -> list:
    for qn in (64, 1):
        for pools in ("bfloat16", "float32", "gather", "onehot"):
            info = gqa_kernel_info(pools, SERVE_BATCH, qn, 32, 8, 128, 128)
            print(f"paged_attention (GQA) kernel at Q={qn} ({pools} pools): "
                  f"{info['rows']} query rows a block, "
                  f"{info['registers']} registers a thread, "
                  f"{info['local_bytes']} local (spill) bytes, "
                  f"{info['smem_bytes']} B of dynamic shared memory a "
                  f"block at H=32, KH=8, D=Dv=128")
            if info["local_bytes"]:
                fail(f"the GQA kernel ({pools}) spills to local memory")
    gen = torch.Generator(device=dev).manual_seed(1)
    pps = -(-(int(SERVE_PROMPTS.max()) + SERVE_GEN) // SERVE_PAGE)
    span = pps * SERVE_PAGE
    cases = {   # Q: (q_lens, lengths) — ragged, incl. an empty slot
        64: ([64, 37, 0, 1], [span, 130, 0, 200]),
        1: ([1, 1, 0, 1], [span, 17, 5, 100]),
    }
    worst, timing, cworst, ctiming = 0.0, {}, 0.0, {}
    for qn, (q_lens, lengths) in cases.items():
        q, k, v, table, ln, ql = _attn_inputs(dev, qn, q_lens, lengths,
                                              pps, gen)
        for window in (0, 100):
            for cap in (0.0, ATTN_SOFTCAP):
                kw = dict(window=window, softcap_val=cap,
                          page_size=SERVE_PAGE)
                got = paged_mixed_attention(q, k, v, table, ln, ql, **kw)
                want = paged_mixed_attention_plain(q, k, v, table, ln, ql,
                                                   **kw)
                k_poison = k.clone()
                k_poison[0] = 3e4
                v_poison = v.clone()
                v_poison[0] = -3e4
                poisoned = paged_mixed_attention(q, k_poison, v_poison,
                                                 table, ln, ql, **kw)
                torch.cuda.synchronize()
                rows = torch.arange(qn, device=dev)[None] < ql[:, None]
                err = float((got - want).abs()[rows].max())
                worst = max(worst, err)
                if not torch.isfinite(got).all() or err > ATTN_TOL:
                    fail(f"paged attention Q={qn} window={window} "
                         f"softcap={cap}: max err {err} > {ATTN_TOL}")
                if not torch.equal(got, poisoned):
                    fail("poisoned page 0 changed the kernel's output")
        kw = dict(page_size=SERVE_PAGE)
        ms = time_ms(lambda: paged_mixed_attention(q, k, v, table, ln, ql,
                                                   **kw), iters=50)
        plain_ms = time_ms(lambda: paged_mixed_attention_plain(
            q, k, v, table, ln, ql, **kw), iters=10)
        lib_ms = _sdpa_ms(q, k, v, table, ln, ql)
        dev_ms = device_ms(lambda: paged_mixed_attention(q, k, v, table, ln,
                                                         ql, **kw))
        lib_dev_ms = device_ms(_sdpa(q, k, v, table, ln, ql))
        bms, by, fbms = _attn_bounds("fp", qn, *_attn_bytes_ops(
            q, k, table, ln, ql, 0))
        timing[qn] = (ms, plain_ms, lib_ms, bms, by, fbms, dev_ms, lib_dev_ms)
        print(f"paged_mixed_attention Q={qn} (S={SERVE_BATCH}, H=32, KH=8, "
              f"D=128, page {SERVE_PAGE}, {pps} pages/slot, bf16 pools, "
              f"q_lens {q_lens}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, sdpa {lib_ms:.4f} ms ({ms / lib_ms:.2f}x kernel/sdpa); "
              f"device time kernel {dev_ms:.4f} ms, sdpa {lib_dev_ms:.4f} ms "
              f"({dev_ms / lib_dev_ms:.2f}x); bound {bms:.4f} ms ({by}, "
              f"TF32), f32 bound {fbms:.4f} ms")
        err, ctiming[qn] = _codec_attention(q, k, v, table, ln, ql, qn, dev)
        cworst = max(cworst, err)
        (cms, cplain, clib, cbms, cby, cdec, conehot, cfbms, cdev,
         clibdev) = ctiming[qn]
        print(f"paged_mixed_attention codec Q={qn} (same shapes, int8 code "
              f"pools + f32 scales): kernel {cms:.4f} ms (onehot "
              f"{conehot:.4f} ms), plain {cplain:.4f} ms, sdpa on the "
              f"decoded f32 view {clib:.4f} ms ({cms / clib:.2f}x "
              f"kernel/sdpa) + decode {cdec:.4f} ms ({cms / (clib + cdec):.2f}"
              f"x kernel/(sdpa + decode)); device time kernel {cdev:.4f} ms, "
              f"sdpa {clibdev:.4f} ms ({cdev / clibdev:.2f}x); bound "
              f"{cbms:.4f} ms ({cby}, TF32), f32 bound {cfbms:.4f} ms")
    print(f"paged_mixed_attention: max abs err {worst:.3e} <= {ATTN_TOL} "
          f"on rows i < q_lens over Q {{64, 1}} x window {{0, 100}} x "
          f"softcap {{0, {ATTN_SOFTCAP}}}; poisoned page 0 inert")
    print(f"paged_mixed_attention codec: max abs err {cworst:.3e} <= "
          f"{ATTN_TOL} vs plain over the same grid; gather and onehot "
          f"bit-identical to the fp kernel on the decoded f32 pools; "
          f"poisoned page-0 codes inert")
    ms, plain_ms, lib_ms, bms, by, fbms, dev_ms, lib_dev_ms = timing[64]
    fp = {"name": "paged_mixed_attention", "route": "cuda",
          "source": "src/repro_torch/csrc/paged_attention.cu",
          "replaces": "src/repro/kernels/paged_attention.py:239",
          "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bms, "bound_by": by, "bound_f32_ms": fbms,
          "library_ms": lib_ms, "device_ms": dev_ms,
          "library_device_ms": lib_dev_ms,
          "shape": "S=4 Q=64 H=32 KH=8 D=128 page=16 bf16 (bound_ms at the "
                   "TF32 tensor-core rate; device_ms: profiler kernel time)",
          "decode_q1": {"ms": timing[1][0], "plain_ms": timing[1][1],
                        "library_ms": timing[1][2],
                        "bound_ms": timing[1][3],
                        "bound_f32_ms": timing[1][5],
                        "device_ms": timing[1][6],
                        "library_device_ms": timing[1][7]}}
    (ms, plain_ms, lib_ms, bms, by, dec_ms, onehot_ms, fbms, dev_ms,
     lib_dev_ms) = ctiming[64]
    codec = {"name": "paged_mixed_attention_codec", "route": "cuda",
             "variant_of": "paged_mixed_attention",
             "source": "src/repro_torch/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention.py:239",
             "max_abs_err": cworst, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bms, "bound_by": by, "bound_f32_ms": fbms,
             "library_ms": lib_ms, "device_ms": dev_ms,
             "library_device_ms": lib_dev_ms,
             "library_decode_ms": dec_ms, "onehot_ms": onehot_ms,
             "shape": "S=4 Q=64 H=32 KH=8 D=128 page=16 int8 codes + f32 "
                      "scales (library_ms: SDPA on the decoded f32 view, "
                      "its decode in library_decode_ms; bound_ms at the "
                      "TF32 tensor-core rate)",
             "decode_q1": {"ms": ctiming[1][0], "plain_ms": ctiming[1][1],
                           "library_ms": ctiming[1][2],
                           "bound_ms": ctiming[1][3],
                           "bound_f32_ms": ctiming[1][7],
                           "device_ms": ctiming[1][8],
                           "library_device_ms": ctiming[1][9],
                           "library_decode_ms": ctiming[1][5]}}
    return [fp, codec]


def _serve(engine, prompts, **kw):
    """The serve phases' requests through a fresh Scheduler: the port's
    main path (``cuda_paged``, chunk 64, page 16) unless ``kw`` says
    otherwise."""
    sched = Scheduler(engine, **{
        "batch_size": SERVE_BATCH, "prefill_chunk": SERVE_CHUNK,
        "kv_page_size": SERVE_PAGE, "attn_backend": "cuda_paged", **kw})
    for p in prompts:
        sched.submit(p, SERVE_GEN)
    t0 = time.monotonic()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if len(done) != len(prompts) or \
            any(len(r.generated) != SERVE_GEN for r in done):
        fail("not every request completed with its full token budget")
    sched.completed = done
    return {r.rid: tuple(r.generated) for r in done}, wall, sched


def _reset_counts() -> None:
    huffman_decode.launches = 0
    paged_mixed_attention.launches = paged_mixed_attention.mla_launches = 0


def _attn_launches(mla: bool) -> int:
    """Attention launches since ``_reset_counts``: with the MLA operand
    on every one for an MLA model, on none for a GQA one."""
    n, n_mla = paged_mixed_attention.launches, \
        paged_mixed_attention.mla_launches
    if n_mla != (n if mla else 0):
        fail(f"{n} attention launches, {n_mla} of them with the MLA "
             f"operand, serving {'an MLA' if mla else 'a GQA'} model")
    return n


def phase_serve(engine, mla=False) -> dict:
    name = "paged_mixed_attention_mla" if mla else "paged_mixed_attention"
    label = "serve mla" if mla else "serve"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, engine.cfg.vocab_size, n)
               for n in SERVE_PROMPTS]
    engine.metrics = ServeMetrics()
    _reset_counts()
    toks1, wall1, _ = _serve(engine, prompts)
    launches = {"huffman_decode": huffman_decode.launches,
                name: _attn_launches(mla)}
    m1, st1 = engine.metrics, engine.cache.stats()
    if not all(launches.values()):
        fail(f"the {label} run did not launch every kernel: {launches}")
    engine.metrics = ServeMetrics()
    toks2, wall2, _ = _serve(engine, prompts)
    m2 = engine.metrics
    if toks1 != toks2:
        fail(f"a second {label} run of the same requests gave other tokens")
    st = engine.cache.stats()
    print(f"{label}: {len(prompts)} requests, prompts "
          f"{SERVE_PROMPTS.tolist()}, gen {SERVE_GEN}, batch {SERVE_BATCH}, "
          f"chunk {SERVE_CHUNK}, page {SERVE_PAGE}, cuda_paged; launches "
          f"{launches}")
    print(f"{label} run 1 (cold tile cache): {wall1:.2f}s, "
          f"{m1.ms_per_token():.2f} ms/step, {m1.tokens_per_s():.1f} tok/s, "
          f"hit rate {st1['hit_rate'] * 100:.1f}% ({st1['misses']} misses)")
    print(f"{label} run 2 (warm): {wall2:.2f}s, {m2.ms_per_token():.2f} "
          f"ms/step, {m2.tokens_per_s():.1f} tok/s; cumulative tile-cache "
          f"hit rate {st['hit_rate'] * 100:.1f}%; tokens identical to run 1")
    print(f"{label} kv gather bytes: {m2.kv_gather_bytes} decode, "
          f"{m2.kv_prefill_gather_bytes} prefill; sample {toks1[0][:8]}")
    if m2.kv_gather_bytes or m2.kv_prefill_gather_bytes:
        fail("the mixed-step path copied KV")
    profile_serve(engine, prompts)
    return launches, prompts, m2, toks1


def phase_serve_codec(engine, prompts, fp_launches, fp_warm,
                      mla=False) -> dict:
    """The same 8 requests on the same registered engine with
    ``kv_codec="cluster"``: int8 code pools + f32 scale pools, decoded
    inside the paged-attention kernel.  Two runs, identical tokens; the
    kernel launched once per layer per tick, as often as in the fp run
    (the schedule does not depend on the values); no KV copied."""
    fp_name = "paged_mixed_attention_mla" if mla else "paged_mixed_attention"
    name = f"{fp_name}_codec"
    label = "serve mla codec" if mla else "serve codec"
    engine.metrics = ServeMetrics()
    _reset_counts()
    toks1, wall1, sched = _serve(engine, prompts, kv_codec="cluster")
    launches = {name: _attn_launches(mla),
                "huffman_decode": huffman_decode.launches}
    m1 = engine.metrics
    want = fp_launches[fp_name]
    if launches[name] != want:
        fail(f"{label} launched the attention kernel {launches[name]} "
             f"times, the fp serve {want} (same schedule expected)")
    pool = sched._pool
    kinds = ({c.dtype for c in tree_leaves(pool.kcache)},
             {x.dtype for x in tree_leaves(pool.kscales)})
    if kinds != ({torch.int8}, {torch.float32}):
        fail(f"codec pools are not int8 codes + f32 scales: {kinds}")
    engine.metrics = ServeMetrics()
    toks2, wall2, sched2 = _serve(engine, prompts, kv_codec="cluster")
    m2 = engine.metrics
    if toks1 != toks2:
        fail(f"a second {label} run of the same requests gave other tokens")
    if m1.kv_gather_bytes or m1.kv_prefill_gather_bytes or \
            m2.kv_gather_bytes or m2.kv_prefill_gather_bytes:
        fail("the codec mixed-step path copied KV")
    print(f"{label}: same requests, kv_codec=cluster; launches "
          f"{launches} (fp run: {want}); pools "
          f"{[tuple(c.shape) for c in tree_leaves(pool.kcache)]} int8 + "
          f"scales {[tuple(x.shape) for x in tree_leaves(pool.kscales)]} "
          f"f32")
    print(f"{label} run 1: {wall1:.2f}s, {m1.ms_per_token():.2f} "
          f"ms/step, {m1.tokens_per_s():.1f} tok/s; run 2: {wall2:.2f}s, "
          f"{m2.ms_per_token():.2f} ms/step, {m2.tokens_per_s():.1f} tok/s; "
          f"fp run 2 (warm): {fp_warm.ms_per_token():.2f} ms/step, "
          f"{fp_warm.tokens_per_s():.1f} tok/s; tokens identical across "
          f"the two codec runs; sample {toks1[0][:8]}")
    t0 = time.monotonic()
    codec_report(sched2._pool, m2)
    print(f"{label}: at-rest report over "
          f"{sum(c.numel() for c in tree_leaves(pool.kcache))} resident "
          f"codes took {time.monotonic() - t0:.1f}s on the host")
    profile_serve(engine, prompts, kv_codec="cluster")
    return launches


def profile_serve(engine, prompts, cpu_ops: bool = True, **kw) -> dict:
    """Where a warm serve run's time goes: one more run of the same
    requests (``_serve``'s path, ``kw`` over its defaults) under
    torch.profiler -> device busy share of the wall time and the kernels
    by device time; plus the host cost of one warm ``materialize`` (every
    tile a cache hit).  Returns the run's warm ms/step, device busy ms and
    paged-attention kernel ms.  ``cpu_ops=False`` records the
    device's kernels alone (a run of tens of thousands of launches then
    reports in seconds, not minutes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.monotonic()
    engine.step_params()
    mat_ms = (time.monotonic() - t0) * 1e3
    hits0 = engine.cache.hits
    engine.metrics = ServeMetrics()
    with profile(activities=[ProfilerActivity.CPU] * cpu_ops
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _serve(engine, prompts, **kw)
        wall_ms = (time.monotonic() - t0) * 1e3
    calls = (engine.cache.hits - hits0) // engine.store.n_tiles(
        engine.model_id) if engine.compressed else 0
    # kernel rows only: an aten op's row repeats its kernels' device time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    attn = [(ms, n) for key, ms, n in rows if "attention_kernel" in key]
    out = {"ms_step": engine.metrics.ms_per_token(), "busy_ms": busy,
           "attn_ms": sum(ms for ms, _ in attn),
           "attn_launches": sum(n for _, n in attn), "mat_ms": mat_ms}
    print(f"profile (warm run, {kw or 'main path'}): wall {wall_ms:.1f} "
          f"ms, {out['ms_step']:.2f} ms/step; {calls} materialize "
          f"calls (one per tick and per admission); one warm materialize, "
          f"timed alone, {mat_ms:.1f} ms on the host")
    if not rows:
        print("profile: device time not measured (the profiler saw no "
              "CUDA kernels)")
        return out
    print(f"profile: device busy {busy:.1f} ms = {busy / wall_ms * 100:.1f}% "
          f"of wall (idle {100 - busy / wall_ms * 100:.1f}%)")
    ranked = sorted(rows, key=lambda r: -r[1])
    # the top 8, and the port's attention kernels wherever they rank
    for i, (key, ms, n) in enumerate(ranked):
        if i < 8 or "attention_kernel" in key:
            print(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    return out


def _use_telemetry(engine, tel) -> None:
    """Point the engine's scheduler hooks and its weight store at ``tel``."""
    engine.telemetry = engine.store.telemetry = tel


def _check_trace(events, rids, label) -> None:
    """The reloaded trace events (metadata dropped): one lifecycle per
    request on its own track, every request-track event inside its
    ``request`` span, engine spans nested by containment, and each
    track's end times in recording order monotone (1 us slack)."""
    eps = 1.0
    last: dict = {}
    for e in events:
        if e["ts"] < 0 or e.get("dur", 0.0) < 0:
            fail(f"{label}: negative timestamp or duration: {e}")
        end = e["ts"] + e.get("dur", 0.0)
        track = (e["pid"], e["tid"])
        if end < last.get(track, -1.0) - eps:
            fail(f"{label}: track {track} goes back in time at {e}")
        last[track] = max(end, last.get(track, -1.0))
    for rid in rids:
        track = [e for e in events
                 if e["pid"] == PID_REQUEST and e["tid"] == rid]
        names = collections.Counter(e["name"] for e in track)
        if any(names[n] != 1 for n in ("queued", "admitted", "request",
                                       "retired", "first_token")):
            fail(f"{label}: request {rid}'s lifecycle events {names}")
        req = next(e for e in track if e["name"] == "request")
        queued = next(e for e in track if e["name"] == "queued")
        lo, hi = req["ts"], req["ts"] + req["dur"]
        if abs(queued["ts"] - lo) > eps or any(
                e["ts"] < lo - eps or e["ts"] + e.get("dur", 0.0) > hi + eps
                for e in track):
            fail(f"{label}: request {rid}'s events leave its request span")
    stack: list = []
    spans = sorted((e for e in events
                    if e["pid"] == PID_ENGINE and e["ph"] == "X"),
                   key=lambda e: (e["ts"], -e["dur"]))
    for e in spans:
        while stack and stack[-1] <= e["ts"] + eps:
            stack.pop()
        end = e["ts"] + e["dur"]
        if stack and end > stack[-1] + eps:
            fail(f"{label}: engine span {e['name']} at {e['ts']:.1f} us "
                 f"overlaps its parent without nesting")
        stack.append(end)


def _phase_lines(label, tel) -> None:
    for phase, h in sorted(tel.phases.items()):
        p50, p99 = h.percentiles(50, 99)
        print(f"{label} phase {phase}: n {h.n}, p50 {p50 * 1e3:.3f} ms, "
              f"p99 {p99 * 1e3:.3f} ms, total {h.total * 1e3:.1f} ms (host)")


def phase_serve_telemetry(engine, prompts, toks, launches) -> None:
    """The main path's 8 requests again from a cold tile cache with
    ``Telemetry(trace=True)``: the tokens and the decode and attention
    launches must be the untraced run's; the Chrome trace, the JSONL and
    the Prometheus text are written to a temporary directory and reloaded
    (one ``request`` span a request, spans nested, timestamps monotone;
    ``parse_prom`` takes the text, whose counters equal ``ServeMetrics``,
    the cache and the store).  Then the phase histograms (host clock),
    warm ms/step with telemetry off and on (tokens and launches equal),
    and the device busy of one profiled warm traced run."""
    tel = Telemetry(trace=True)
    _use_telemetry(engine, tel)
    engine.cache.clear()
    engine.cache.reset_counters()
    engine.metrics = ServeMetrics()
    _reset_counts()
    got, wall, sched = _serve(engine, prompts)
    counts = {"huffman_decode": huffman_decode.launches,
              "paged_mixed_attention": _attn_launches(False)}
    if got != toks:
        fail("the traced serve gave other tokens than the untraced one")
    if counts != launches:
        fail(f"the traced serve launched {counts}, the untraced {launches}")
    m, st = engine.metrics, engine.cache.stats()
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in
                 ("trace.json", "trace.jsonl", "metrics.prom")]
        tel.tracer.write_chrome(paths[0])
        tel.tracer.write_jsonl(paths[1])
        with open(paths[2], "w") as f:
            f.write(engine.render_prom())
        with open(paths[0]) as f:
            chrome = json.load(f)
        with open(paths[1]) as f:
            jsonl = [json.loads(line) for line in f]
        with open(paths[2]) as f:
            text = f.read()
        sizes = [os.path.getsize(p) for p in paths]
    events = [e for e in chrome["traceEvents"] if e["ph"] != "M"]
    if jsonl != events or len(events) != len(tel.tracer.events):
        fail("the JSONL events differ from the Chrome trace's")
    rids = sorted(r.rid for r in sched.completed)
    n_req = sum(e["name"] == "request" and e["pid"] == PID_REQUEST
                for e in events)
    if n_req != len(prompts):
        fail(f"{n_req} request spans for {len(prompts)} requests")
    _check_trace(events, rids, "serve telemetry")
    prom = parse_prom(text)
    want = {"repro_tokens_generated_total": m.tokens_generated,
            "repro_requests_completed_total": m.requests_completed,
            "repro_decode_steps_total": m.decode_steps,
            "repro_prefill_chunks_total": m.prefill_chunks,
            "repro_kv_gather_bytes_total": m.kv_gather_bytes,
            "repro_cache_hits_total": st["hits"],
            "repro_cache_misses_total": st["misses"],
            "repro_cache_evictions_total": st["evictions"],
            "repro_cache_bytes_streamed_total": st["bytes_streamed"],
            "repro_store_prefetch_dispatched_total":
                engine.store.prefetch_dispatched,
            "repro_ttft_seconds_count": m.ttft_hist.n,
            "repro_decode_step_seconds_count": m.step_hist.n}
    for phase, h in tel.phases.items():
        safe = phase.replace(".", "_").replace("-", "_")
        want[f"repro_phase_{safe}_seconds_count"] = h.n
        n_spans = sum(e["name"] == phase and e["pid"] == PID_ENGINE
                      for e in events)
        if n_spans != h.n:
            fail(f"phase {phase}: {h.n} timings, {n_spans} spans")
    got_prom = {k: prom.get((k, "")) for k in want}
    if got_prom != {k: float(v) for k, v in want.items()}:
        fail(f"the Prometheus text disagrees with the counters: "
             f"{got_prom} vs {want}")
    sample = engine.metrics.registry(cache=engine.cache, store=engine.store,
                                     telemetry=tel).sample()
    if any(prom[(k, "")] != v for k, v in sample.items()):
        fail("a Prometheus scalar does not re-parse to its value")
    print(f"serve telemetry: cold traced run {wall:.2f}s, tokens and "
          f"launches {counts} those of the untraced run; "
          f"{len(events)} events ({n_req} request spans), trace / JSONL / "
          f"Prometheus {sizes} bytes, reloaded; {len(prom)} samples, "
          f"counters equal ServeMetrics, the cache and the store; spans "
          f"nested, timestamps monotone")
    _phase_lines("serve telemetry cold", tel)
    # warm, off then on: the gates are tokens and launches, the ms/step
    # host-clock figures are printed for information
    runs = {}
    for name, rec in (("off", NULL_TELEMETRY), ("on", Telemetry(trace=True))):
        _use_telemetry(engine, rec)
        engine.metrics = ServeMetrics()
        _reset_counts()
        got, wall, _ = _serve(engine, prompts)
        runs[name] = (got, huffman_decode.launches, _attn_launches(False),
                      engine.metrics.ms_per_token(), wall, rec)
    if runs["off"][:3] != runs["on"][:3] or runs["on"][0] != toks:
        fail("warm serves with telemetry off and on differ in tokens or "
             "launches")
    print(f"serve telemetry warm: off {runs['off'][3]:.2f} ms/step "
          f"({runs['off'][4]:.2f}s), on {runs['on'][3]:.2f} ms/step "
          f"({runs['on'][4]:.2f}s), host clock, for information; tokens and "
          f"launches (decode {runs['on'][1]}, attention {runs['on'][2]}) "
          f"equal")
    _phase_lines("serve telemetry warm", runs["on"][5])
    _use_telemetry(engine, Telemetry(trace=True))
    prof = profile_serve(engine, prompts)
    print(f"serve telemetry warm traced run profiled: device busy "
          f"{prof['busy_ms']:.1f} ms, {prof['ms_step']:.2f} ms/step, "
          f"attention kernel {prof['attn_ms']:.3f} ms "
          f"x{prof['attn_launches']}")
    _phase_lines("serve telemetry profiled", engine.telemetry)
    _use_telemetry(engine, NULL_TELEMETRY)


def phase_cache_auto(engine, prompts, toks, launches) -> None:
    """``--cache-mb auto`` on the full-width store: the capacity sweep
    (host only) prints the working set, the knee, its fraction and the
    projected hit rate with its seconds; the 8 requests then serve from a
    cold cache at the knee and must give the unbounded run's tokens
    (capacity changes speed only) and its attention launches.  The
    measured hit rate is printed beside the projected one, not gated."""
    n_tiles = engine.store.n_tiles(engine.model_id)
    t0 = time.monotonic()
    rec = recommend_store_capacity(engine.store, engine.model_id,
                                   policy=engine.cache.policy.name)
    secs = time.monotonic() - t0
    curve = ", ".join(f"{c / rec['working_set']:.2f}x {r * 100:.1f}%"
                      for c, r in zip(rec["capacities"], rec["rates"]))
    print(f"cache auto: working set {rec['working_set']} B "
          f"({rec['working_set'] / 2 ** 20:.2f} MiB, {n_tiles} tiles); "
          f"knee {rec['capacity']} B ({rec['capacity'] / 2 ** 20:.2f} MiB, "
          f"{rec['fraction']:.2f}x); projected hit rate "
          f"{rec['hit_rate'] * 100:.1f}% (best {rec['best_rate'] * 100:.1f}"
          f"%); sweep {secs:.2f}s on the host ({len(rec['capacities'])} "
          f"capacities x 8 steps x {n_tiles} tiles)")
    print(f"cache auto sweep: {curve}")
    engine.cache.clear()
    engine.cache.reset_counters()
    engine.cache.capacity_bytes = rec["capacity"]
    engine.metrics = ServeMetrics()
    _reset_counts()
    try:
        got, wall, _ = _serve(engine, prompts)
        n_dec, n_attn = huffman_decode.launches, _attn_launches(False)
    finally:
        engine.cache.capacity_bytes = None
    st = engine.cache.stats()
    if got != toks:
        fail("serving at the recommended capacity gave other tokens than "
             "the unbounded run")
    if n_attn != launches["paged_mixed_attention"] or \
            n_dec < launches["huffman_decode"]:
        fail(f"serving at the recommended capacity launched decode {n_dec} "
             f"and attention {n_attn} times; unbounded: {launches}")
    print(f"cache auto serve: {wall:.2f}s from a cold cache at "
          f"{rec['capacity']} B, {engine.metrics.ms_per_token():.2f} "
          f"ms/step; measured hit rate {st['hit_rate'] * 100:.1f}% "
          f"(projected {rec['hit_rate'] * 100:.1f}% over 8 steps), "
          f"{st['evictions']} evictions, decode launches {n_dec} "
          f"(unbounded {launches['huffman_decode']}), attention {n_attn}; "
          f"tokens those of the unbounded run")


# the serving paths beside the main one, each over _serve's defaults (cuda_paged,
# chunk 64, page 16): the gathered backend (plain PyTorch attention over
# lane views gathered from the pages), monolithic prefill installed into
# the pages, one monolithic lane a slot, wave admission, the gathered codec
BACKEND_PATHS = (
    ("gathered, monolithic prefill, page 16",
     dict(attn_backend="gathered", prefill_chunk=None)),
    ("cuda_paged, monolithic prefill, page 16",
     dict(prefill_chunk=None)),
    ("gathered, monolithic prefill, monolithic lanes",
     dict(attn_backend="gathered", prefill_chunk=None, kv_page_size=None)),
    ("wave, cuda_paged, chunk 64, page 16", dict(mode="wave")),
    ("gathered, codec, monolithic prefill, page 16",
     dict(attn_backend="gathered", prefill_chunk=None, kv_codec="cluster")),
)


def phase_serve_paths(engine, prompts, ref, paths, mla=False) -> None:
    """The same requests on the registered engine along each of ``paths``
    (label, Scheduler arguments), each run from a cold tile cache with the
    launch counts set to 0 just before it and read just after: the decode
    kernel runs on every path and the attention kernel on every
    cuda_paged one, never on a gathered one (the gathered attention is
    plain PyTorch, the kernels' oracle); a monolithic cuda_paged run
    launches it once a layer a decode step.  Copy counters are the
    reference's formulas.  Prints ms/step, tok/s, copied bytes, one warm
    ``materialize`` and the share of tokens that agree with ``ref`` (the
    main path's tokens) and with the first path's (the gathered
    monolithic oracle: a path with the same monolithic prefill gives its
    first tokens), then profiles a warm run."""
    name = "serve mla" if mla else "serve"
    total = sum(len(t) for t in ref.values())

    def agree(a, b):
        n = sum(x == y for i in a for x, y in zip(a[i], b[i]))
        return f"{n}/{total} ({n / total * 100:.1f}%)"

    first = None
    for label, kw in paths:
        engine.cache.clear()
        engine.metrics = ServeMetrics()
        _reset_counts()
        toks, wall, sched = _serve(engine, prompts, **kw)
        n_attn = _attn_launches(mla)
        n_dec = huffman_decode.launches
        m, pool = engine.metrics, sched._pool
        kernel = pool.backend == "cuda_paged"
        mixed = kernel and sched.prefill_chunk is not None
        if not n_dec or bool(n_attn) != kernel:
            fail(f"{name} [{label}]: {n_dec} decode and {n_attn} attention "
                 f"launches")
        if kernel and not mixed and \
                n_attn != m.decode_steps * engine.cfg.num_layers:
            fail(f"{name} [{label}]: {n_attn} attention launches for "
                 f"{m.decode_steps} Q=1 steps of {engine.cfg.num_layers} "
                 f"layers")
        install = 0 if mixed else len(prompts) * pool.install_bytes
        if (m.kv_prefill_gather_bytes, m.kv_gather_bytes) != \
                (install, m.decode_steps * pool.gather_bytes_per_step):
            fail(f"{name} [{label}]: copied {m.kv_prefill_gather_bytes} / "
                 f"{m.kv_gather_bytes} bytes, expected {install} / "
                 f"{m.decode_steps} x {pool.gather_bytes_per_step}")
        first = first or toks
        print(f"{name} [{label}]: {wall:.2f}s from a cold tile cache, "
              f"{m.ms_per_token():.2f} ms/step, {m.tokens_per_s():.1f} "
              f"tok/s, {m.waves} waves; launches: decode {n_dec}, attention "
              f"{n_attn}; kv gather {m.kv_gather_bytes} B "
              f"({pool.gather_bytes_per_step} a step), install "
              f"{m.kv_prefill_gather_bytes} B; tokens agreeing with the "
              f"main path's {agree(ref, toks)}, with [{paths[0][0]}]'s "
              f"{agree(first, toks)}")
        prof = profile_serve(engine, prompts, **kw)
        print(f"{name} [{label}] warm: {prof['ms_step']:.2f} ms/step, "
              f"device busy {prof['busy_ms']:.1f} ms, attention kernel "
              f"{prof['attn_ms']:.3f} ms x{prof['attn_launches']}, one warm "
              f"materialize {prof['mat_ms']:.1f} ms")


def _installed_pool(engine, params, firsts, slot_len, **kw):
    """A fresh SlotPool with every (request, first token, batch-1 prefill
    cache) of ``firsts`` installed into one slot."""
    pool = SlotPool(engine, SERVE_BATCH, slot_len, **kw)
    for slot, (req, tok, cache1) in zip(pool.slots, firsts):
        slot.req = req
        if not pool.reserve_for(slot, req):
            fail("the logits check's pool cannot back its requests")
        pool.install(slot, cache1, tok)
    return pool


def _shift_first_page(pool, slot: int = 0) -> None:
    """The planted fault: the slot's first page in every kernel-layout
    pool, and its rolling lane beside them, shifted down by one row (row
    0 repeated, the last key lost), as an install that is one token off
    would leave them."""
    page = int(pool.table[slot, 0])
    for leaf, ax, bax in zip(tree_leaves(pool.kcache), pool._paged_axis,
                             pool._batch_axis):
        rows = leaf.select(bax, slot).movedim(bax, 0) if ax is None else \
            leaf.select(ax - 1, page).movedim(ax - 1, 0)
        rows[1:] = rows[:-1].clone()


def phase_decode_logits(cfg, dev, prompts, mla=False, label=None) -> None:
    """The first SERVE_BATCH requests prefilled monolithically at full
    width, installed into a fresh pool of each layout, and one decode
    step's logits compared: gathered pages (page 16) and monolithic lanes
    bit for bit (the gather is an exact copy), the kernel path
    (``cuda_paged`` install, the attention kernel at Q=1) against the
    gathered one within LOGIT_ULP_FACTOR times the bf16 noise floor, and a
    kernel pool with a planted one-row shift must break that tolerance.

    The engine serves ``cfg``'s bf16 MLP weights uncompressed (random from
    seed 0): a binarised MLP takes the sign of its input, so a rounding
    difference there can flip a bit and move the logits by a whole
    weight, and no tolerance would then tell rounding from a fault.  The
    install, the gather and the kernel are the same code either way.
    Rolling-window lanes (a window shorter than the slot) sit beside the
    pages in every layout and take the ulp flip too."""
    name = label or ("serve mla" if mla else "serve")
    engine = ServeEngine(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev), device=dev,
        compress=False)
    params = engine.step_params()
    reqs = [Request(i, np.asarray(p, np.int32), SERVE_GEN)
            for i, p in enumerate(prompts[:SERVE_BATCH])]
    need = max(engine.cache_len(r.prompt_len, SERVE_GEN) for r in reqs)
    slot_len = -(-need // SLOT_LEN_QUANTUM) * SLOT_LEN_QUANTUM
    engine.metrics = ServeMetrics()
    firsts = [(r, *engine.prefill_request(params, r.prompt, slot_len))
              for r in reqs]
    paged = dict(page_size=SERVE_PAGE)
    layouts = {"cuda_paged": dict(backend="cuda_paged", **paged),
               "gathered": dict(backend="gathered", **paged),
               "lanes": dict(backend="gathered")}
    pools = {k: _installed_pool(engine, params, firsts, slot_len, **kw)
             for k, kw in layouts.items()}
    pool = _installed_pool(engine, params, firsts, slot_len,
                           **layouts["gathered"])
    for pg in pool.pages + pool.unpaged:
        if pg.dtype != torch.bfloat16:
            fail(f"{name}: the logits check expects bf16 pages, not "
                 f"{pg.dtype}")
        pg.view(torch.int16).bitwise_xor_(1)
    pools["ulp"] = pool
    pool = _installed_pool(engine, params, firsts, slot_len,
                           **layouts["cuda_paged"])
    _shift_first_page(pool)
    pools["fault"] = pool
    with torch.no_grad():
        out = {k: p.decode_logits(params)[:len(reqs)].float()
               for k, p in pools.items()}
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        fail(f"{name}: non-finite first-decode logits")

    def diff(k):
        return float((out[k] - out["gathered"]).abs().max())

    floor = diff("ulp")
    tol = LOGIT_ULP_FACTOR * floor
    err, fault = diff("cuda_paged"), diff("fault")
    exact = torch.equal(out["lanes"], out["gathered"])
    print(f"{name} first-decode logits, uncompressed MLPs ({len(reqs)} "
          f"requests, prompts "
          f"{[r.prompt_len for r in reqs]}, monolithic prefill, "
          f"{out['gathered'].shape[-1]} logits, max |logit| "
          f"{float(out['gathered'].abs().max()):.3f}): monolithic lanes vs "
          f"gathered page {SERVE_PAGE} {'bit for bit' if exact else 'DIFFER'};"
          f" max abs diff vs gathered: cuda_paged kernel {err:.4e}, one bf16 "
          f"ulp on every cached K/V {floor:.4e} (tolerance {LOGIT_ULP_FACTOR}"
          f"x = {tol:.4e}), planted one-row shift of slot 0's first "
          f"kernel page (and lanes) "
          f"{fault:.4e}")
    if not exact:
        fail(f"{name}: monolithic lanes' logits differ from gathered "
             f"pages' by {diff('lanes'):.4e}")
    if not 0 < floor or not err <= tol:
        fail(f"{name}: the kernel path's first-decode logits differ from "
             f"the gathered path's by {err:.4e} (tolerance {tol:.4e})")
    if not fault > tol:
        fail(f"{name}: the logits check does not see a planted one-row "
             f"shift ({fault:.4e} <= {tol:.4e})")


# the small models' paths, card against CPU: the main path with fp and
# codec pools, then every path of BACKEND_PATHS (small: chunk 3, page 4)
SMALL_PATHS = (
    dict(prefill_chunk=3, kv_page_size=4),
    dict(prefill_chunk=3, kv_page_size=4, kv_codec="cluster"),
    dict(attn_backend="gathered"),
    dict(attn_backend="gathered", kv_page_size=4),
    dict(attn_backend="gathered", prefill_chunk=3, kv_page_size=4),
    dict(attn_backend="gathered", kv_page_size=4, kv_codec="cluster"),
    dict(attn_backend="gathered", prefill_chunk=3, kv_page_size=4,
         kv_codec="cluster"),
    dict(kv_page_size=4),
    dict(kv_page_size=4, kv_codec="cluster"),
    dict(mode="wave", attn_backend="gathered"),
    dict(mode="wave", prefill_chunk=3, kv_page_size=4),
)


# prefix sharing (both backends, fp and codec) and speculation (n-gram
# and draft model; monolithic lanes, gathered pages, cuda_paged), card
# against CPU with their counters, on prompts extending one 16-token
# prefix and prompts repeating a pattern
SHARED_PATHS = (
    dict(prefill_chunk=3, kv_page_size=4, prefix_share=True),
    dict(prefill_chunk=4, kv_page_size=8, prefix_share=True,
         kv_codec="cluster"),
    dict(attn_backend="gathered", prefill_chunk=3, kv_page_size=4,
         prefix_share=True),
    dict(attn_backend="gathered", prefill_chunk=4, kv_page_size=8,
         prefix_share=True, kv_codec="cluster"),
    dict(attn_backend="gathered", speculate="ngram"),
    dict(attn_backend="gathered", speculate="draft"),
    dict(attn_backend="gathered", kv_page_size=4, speculate="ngram"),
    dict(attn_backend="gathered", kv_page_size=4, speculate="draft",
         kv_codec="cluster"),
    dict(prefill_chunk=3, kv_page_size=4, speculate="ngram"),
    dict(prefill_chunk=3, kv_page_size=4, speculate="draft"),
    dict(kv_page_size=2, speculate="ngram", draft_k=6),
    dict(prefill_chunk=4, kv_page_size=4, prefix_share=True,
         speculate="ngram", draft_k=6),
)
SHARED_COUNTERS = ("prefix_hits", "prefix_tokens_reused",
                   "prefix_cow_copies", "prefix_evictions", "spec_rounds",
                   "spec_draft_tokens", "spec_accepted_tokens",
                   "decode_steps")


def phase_small_reference(dev, cfg, label, shared: bool = False,
                          paths=SMALL_PATHS) -> None:
    """A small model served on the card gives the CPU's tokens, on every
    path of ``SMALL_PATHS`` (and with ``shared``, on its own requests, of
    ``SHARED_PATHS``, with equal prefix and speculation counters).  Its dense MLP weights
    are +-1 (unit scale), so every binarised product is an exact integer
    on either device; with other scales, a unit whose +-alpha terms
    cancel exactly is rounding noise whose sign follows the BLAS's
    summation order (as it does in the JAX reference).  The draft model
    is one tree made on the CPU, its MLPs at unit scale too, given to
    both devices' drafters."""
    unit = lambda tree: tree_map_with_path(
        lambda path, w: torch.where(w >= 0, 1.0, -1.0)
        if "mlp" in path.split("/") else w, tree)
    params = unit(init_params(cfg, torch.Generator().manual_seed(3), "cpu"))
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab_size, n), g)
            for n, g in ((5, 7), (12, 2), (20, 5), (6, 9), (3, 1), (9, 4))]
    common = rng.integers(0, cfg.vocab_size, 16)
    shared_reqs = [(np.concatenate([common, rng.integers(
        0, cfg.vocab_size, t)]), g) for t, g in ((3, 5), (5, 4), (2, 6),
                                                 (6, 3))]
    shared_reqs += [(np.tile(rng.integers(0, cfg.vocab_size, 3), 4), 12)
                    for _ in range(2)]
    small = paths
    paths = small + SHARED_PATHS if shared else small
    draft = unit(init_params(draft_config(cfg.vocab_size),
                             torch.Generator().manual_seed(4), "cpu"))
    make = sched_mod.make_drafter
    sched_mod.make_drafter = lambda spec, eng=None: DraftModelDrafter(
        eng, params=draft) if spec == "draft" else make(spec, eng)
    engines = {str(d): ServeEngine(cfg, params, device=d)
               for d in ("cpu", dev)}
    notes, counts = [], {}
    try:
        for kw in paths:
            out = {}
            for device, engine in engines.items():
                engine.metrics = ServeMetrics()
                sched = Scheduler(engine, batch_size=2, buckets=(8, 32),
                                  emit=notes.append,
                                  **{"attn_backend": "cuda_paged", **kw})
                for r in shared_reqs if kw in SHARED_PATHS else reqs:
                    sched.submit(*r)
                out[device] = ({r.rid: tuple(r.generated)
                                for r in sched.run()},
                               {k: getattr(engine.metrics, k)
                                for k in SHARED_COUNTERS})
            if out["cpu"] != out[str(dev)]:
                fail(f"{label} ({kw}) on the card gave other tokens or "
                     f"counters than on the CPU: {out}")
            if kw in SHARED_PATHS:
                counts[str(kw)] = out["cpu"][1]
    finally:
        sched_mod.make_drafter = make
    print(f"small reference: {label} ({cfg.d_model} wide, f32) serves "
          f"{len(reqs)} requests to identical tokens on cuda and cpu on "
          f"{len(small)} paths: {list(small)}")
    if shared:
        print(f"small reference: {label} serves {len(shared_reqs)} requests "
              f"(four extending one 16-token prefix, two repeating a "
              f"3-token pattern) to identical tokens and counters on cuda "
              f"and cpu on {len(SHARED_PATHS)} paths:")
    for kw, c in counts.items():
        print(f"  {kw}: counters equal on cuda and cpu: {c}")
    for note in sorted(set(notes)):
        print(f"  {note}")


def phase_decode_wrapper(dev) -> None:
    """``paged_decode_attention``, the Q=1 wrapper, on the card at
    minitron-8b's widths (32 query / 8 KV heads, D 128) and deepseek-v2's
    MLA widths, bf16 pools with page 0 poisoned, against the plain
    version at Q=1 (``ATTN_TOL``); one kernel launch a call.  These
    launches are comparisons and count for no path."""
    cfg = get_config("minitron-8b")
    gen = torch.Generator(device=dev).manual_seed(5)
    pps = -(-(int(SERVE_PROMPTS.max()) + SERVE_GEN) // SERVE_PAGE)
    lengths = [pps * SERVE_PAGE, 17, 1, 200]
    ones = [1] * SERVE_BATCH
    q, k, v, table, ln, ql = _attn_inputs(
        dev, 1, ones, lengths, pps, gen, h=cfg.num_heads,
        kh=cfg.num_kv_heads, d=cfg.head_dim)
    k[0], v[0] = 3e4, -3e4
    cases = [("minitron-8b", (q, k, v, table, ln), {}, {})]
    q, c, q2, pe, table, ln, ql = _mla_inputs(dev, 1, ones, lengths, pps,
                                              gen)
    c[0], pe[0] = 3e4, 3e4
    cases.append(("deepseek-v2-236b (MLA)", (q, c, c, table, ln),
                  {"q2": q2}, {"k2_pages": pe, "scale": MLA_SCALE}))
    for label, (q, k, v, table, ln), qs, kw in cases:
        n0 = paged_mixed_attention.launches
        got = paged_decode_attention(
            q[:, 0], k, v, table, ln,
            **{n: a[:, 0] for n, a in qs.items()}, page_size=SERVE_PAGE,
            **kw)
        launched = paged_mixed_attention.launches - n0
        want = paged_mixed_attention_plain(
            q, k, v, table, ln, ql, **qs, page_size=SERVE_PAGE, **kw)[:, 0]
        err = float((got - want).abs().max())
        if launched != 1 or not err <= ATTN_TOL:
            fail(f"paged_decode_attention at {label} widths: {launched} "
                 f"launches, max abs err {err:.3e} (tolerance {ATTN_TOL})")
        print(f"paged_decode_attention (Q=1) at {label} widths, bf16 pools, "
              f"page 0 poisoned: {tuple(got.shape)}, max abs err vs plain "
              f"{err:.3e} <= {ATTN_TOL}, 1 kernel launch")


def phase_small_mla_reference(dev) -> None:
    """The small-model check on deepseek-v2 at the reduced widths the
    JAX package's tests use: MLA attention through the kernel's second
    operand, shared + routed experts (no drops at capacity factor 8)."""
    phase_small_reference(
        dev, get_config(MLA_ARCH).scaled(dtype="float32", vocab_size=128,
                                         **SMALL_MLA),
        "reduced deepseek-v2", True)


def phase_fused_operands(engine, dev) -> None:
    """``WeightStore.fused_operands`` on one full-width MLP matrix: the
    fused decode+GEMM of a real activation equals sign(x) @ the signs of
    the materialised weights (both from the same cache-served tiles)."""
    t0 = time.monotonic()
    words, tables, meta = engine.store.fused_operands(engine.model_id,
                                                      "scan/b0/mlp/up")
    host_s = time.monotonic() - t0
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((16, meta["k_true"]), generator=gen, device=dev)
    got = ops.compressed_binary_matmul(x, words, tables, k_true=meta["k_true"],
                                       n_true=meta["n_true"],
                                       codes=meta["codes"])
    w = engine.store.materialize(engine.model_id)["scan"]["b0"]["mlp"]["up"][0]
    want = torch.where(x >= 0, 1.0, -1.0) @ torch.where(w.float() >= 0, 1.0,
                                                        -1.0)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"fused_operands: fused GEMM differs from the materialised "
             f"weights' binary product at {int((got != want).sum())} of "
             f"{got.numel()} outputs")
    print(f"fused_operands: scan/b0/mlp/up ({meta['n_true']}x{meta['k_true']}"
          f" bits, words {tuple(words.shape)}) built in {host_s:.1f}s on the "
          f"host; compressed_binary_matmul of a (16, {meta['k_true']}) "
          f"activation == sign(x) @ materialised signs")


def _mla_inputs(dev, qn, q_lens, lengths, pps, gen):
    """The MLA kernel call at deepseek-v2's serving widths: one latent KV
    head whose (n_pages, 16, 1, 512) bf16 pool is both key and value, a
    (n_pages, 16, 1, 64) rope pool, q (S, Q, 128, 512) and q2
    (S, Q, 128, 64) in f32, ragged like the GQA case."""
    q, c, _, table, ln, ql = _attn_inputs(dev, qn, q_lens, lengths, pps,
                                          gen, h=MLA_HEADS, kh=1,
                                          d=MLA_LATENT)
    pe = torch.randn((*c.shape[:3], MLA_ROPE), generator=gen,
                     device=dev).to(torch.bfloat16)
    q2 = torch.randn((*q.shape[:3], MLA_ROPE), generator=gen, device=dev)
    return q * MLA_LATENT ** 0.5, c, q2, pe, table, ln, ql


def _mla_case(q, c, q2, pe, table, ln, ql, qn, dev) -> tuple:
    """One serve shape of the MLA kernel: fp (bf16 pools) against the
    plain version over window {0, 100} x softcap {0, 4}, poisoned page 0
    inert; the codec kernel (``gather`` and ``onehot``) bit-identical to
    the fp kernel on the decoded f32 pools, within ATTN_TOL of its plain
    version, poisoned page-0 codes, scales and k2 rows inert -> (worst fp
    error, worst codec error, timings)."""
    (cc, cs), (pc, ps) = (kv_codec.encode(x, (-2, -1)) for x in (c, pe))
    cb = kv_codec.codebook(dev)
    cd, pd = decode_pool(cc, cs, cb), decode_pool(pc, ps, cb)
    rows = torch.arange(qn, device=dev)[None] < ql[:, None]
    worst, cworst = 0.0, 0.0
    for window in (0, 100):
        for cap in (0.0, ATTN_SOFTCAP):
            kw = dict(window=window, softcap_val=cap, scale=MLA_SCALE,
                      page_size=SERVE_PAGE)
            got = paged_mixed_attention(q, c, c, table, ln, ql, q2, pe, **kw)
            want = paged_mixed_attention_plain(q, c, c, table, ln, ql, q2=q2,
                                               k2_pages=pe, **kw)
            cp, pp = c.clone(), pe.clone()
            cp[0], pp[0] = 3e4, -3e4
            poisoned = paged_mixed_attention(q, cp, cp, table, ln, ql, q2,
                                             pp, **kw)
            fp = paged_mixed_attention(q, cd, cd, table, ln, ql, q2, pd,
                                       **kw)
            cwant = paged_mixed_attention_plain(
                q, cc, cc, table, ln, ql, cs, cs, cb, q2=q2, k2_pages=pc,
                k2_scales=ps, **kw)
            codec = {d: paged_mixed_attention(q, cc, cc, table, ln, ql, q2,
                                              pc, cs, cs, ps, cb, dequant=d,
                                              **kw)
                     for d in ("gather", "onehot")}
            ccp, pcp, csp, psp = cc.clone(), pc.clone(), cs.clone(), ps.clone()
            ccp[0], pcp[0], csp[0], psp[0] = 127, -127, 1e6, 1e6
            cpoisoned = paged_mixed_attention(q, ccp, ccp, table, ln, ql, q2,
                                              pcp, csp, csp, psp, cb, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs()[rows].max())
            cerr = float((codec["gather"] - cwant).abs()[rows].max())
            worst, cworst = max(worst, err), max(cworst, cerr)
            where = f"MLA Q={qn} window={window} softcap={cap}"
            if not torch.isfinite(got).all() or err > ATTN_TOL:
                fail(f"paged attention {where}: max err {err} > {ATTN_TOL}")
            if not torch.equal(got, poisoned):
                fail(f"poisoned page 0 changed the {where} output")
            if cerr > ATTN_TOL:
                fail(f"codec paged attention {where}: max err {cerr} > "
                     f"{ATTN_TOL}")
            for d, out in codec.items():
                if not torch.equal(out, fp):
                    fail(f"codec kernel ({d}) {where} differs from the fp "
                         f"kernel on the decoded f32 pools at "
                         f"{int((out != fp).sum())} outputs")
            if not torch.equal(codec["gather"], cpoisoned):
                fail(f"poisoned page-0 codes changed the codec {where} "
                     f"output")
    kw = dict(scale=MLA_SCALE, page_size=SERVE_PAGE)
    ckw = dict(k2_scales=ps, codebook=cb, **kw)
    ms = time_ms(lambda: paged_mixed_attention(q, c, c, table, ln, ql, q2,
                                               pe, **kw), iters=20)
    plain_ms = time_ms(lambda: paged_mixed_attention_plain(
        q, c, c, table, ln, ql, q2=q2, k2_pages=pe, **kw), iters=5)
    cms = time_ms(lambda: paged_mixed_attention(
        q, cc, cc, table, ln, ql, q2, pc, cs, cs, **ckw), iters=20)
    onehot_ms = time_ms(lambda: paged_mixed_attention(
        q, cc, cc, table, ln, ql, q2, pc, cs, cs, dequant="onehot", **ckw),
        iters=2, warmup=1)
    cplain_ms = time_ms(lambda: paged_mixed_attention_plain(
        q, cc, cc, table, ln, ql, cs, cs, cb, q2=q2, k2_pages=pc,
        k2_scales=ps, **kw), iters=5)
    decode_ms = time_ms(lambda: (decode_pool(cc, cs, cb),
                                 decode_pool(pc, ps, cb)), iters=20)
    # the same function in one SDPA call: q || q2 against c || pe (D =
    # 576), values c, on the gathered view
    lib_ms = _sdpa_ms(torch.cat([q, q2], -1), torch.cat([c, pe], -1), c,
                      table, ln, ql, scale=MLA_SCALE)
    clib_ms = _sdpa_ms(torch.cat([q, q2], -1), torch.cat([cd, pd], -1), cd,
                       table, ln, ql, scale=MLA_SCALE)
    # the kernel runs both products on tensor cores, so its bound is the
    # function's operations at the TF32 rate (the split's extra MMAs are
    # the kernel's cost, not the function's); the f32 CUDA-core bound is
    # printed beside it
    nbytes, ops = _attn_bytes_ops(q, c, table, ln, ql, 0, q2=q2, k2=pe,
                                  shared_kv=True)
    bms, by = bound_ms(nbytes, ops, ops_per_s=TF32_OPS_PER_S)
    f32_bms, _ = bound_ms(nbytes, ops)
    cbytes, cops = _attn_bytes_ops(q, cc, table, ln, ql, 0, codec=True,
                                   q2=q2, k2=pc, shared_kv=True)
    cbms, cby = bound_ms(cbytes, cops, ops_per_s=TF32_OPS_PER_S)
    cf32_bms, _ = bound_ms(cbytes, cops)
    for label, b, o, tb, fb in (("", nbytes, ops, bms, f32_bms),
                                (" codec", cbytes, cops, cbms, cf32_bms)):
        print(f"  MLA{label} Q={qn} bounds: bytes "
              f"{b / HBM_BYTES_PER_S * 1e3:.4f} ms ({b} B), operations "
              f"{o / TF32_OPS_PER_S * 1e3:.4f} ms at the TF32 tensor-core "
              f"rate, {o / F32_OPS_PER_S * 1e3:.4f} ms at the f32 CUDA-core "
              f"rate ({o} ops): bound {tb:.4f} ms (TF32), {fb:.4f} ms (f32)")
    return worst, cworst, ((ms, plain_ms, lib_ms, bms, by, f32_bms),
                           (cms, cplain_ms, clib_ms, cbms, cby, decode_ms,
                            onehot_ms, cf32_bms))


def phase_attention_mla(dev) -> list:
    """The MLA paged-attention kernel at deepseek-v2's serving shapes,
    against its plain version, fp and codec."""
    for qn in (64, 1):
        for pools in ("bfloat16", "float32", "gather", "onehot"):
            info = mla_kernel_info(pools, SERVE_BATCH, qn, MLA_HEADS,
                                   MLA_LATENT, MLA_ROPE)
            print(f"paged_mla_attention kernel at Q={qn} ({pools} pools): "
                  f"{info['rows']} query rows a block, "
                  f"{info['registers']} registers a thread, "
                  f"{info['local_bytes']} local (spill) bytes, "
                  f"{info['smem_bytes']} B of dynamic shared memory a "
                  f"block at D={MLA_LATENT}, D2={MLA_ROPE}")
            if info["local_bytes"]:
                fail(f"the MLA kernel ({pools}) spills to local memory")
    gen = torch.Generator(device=dev).manual_seed(5)
    pps = -(-(int(SERVE_PROMPTS.max()) + SERVE_GEN) // SERVE_PAGE)
    span = pps * SERVE_PAGE
    cases = {64: ([64, 37, 0, 1], [span, 130, 0, 200]),
             1: ([1, 1, 0, 1], [span, 17, 5, 100])}
    worst, cworst, timing = 0.0, 0.0, {}
    for qn, (q_lens, lengths) in cases.items():
        args = _mla_inputs(dev, qn, q_lens, lengths, pps, gen)
        err, cerr, timing[qn] = _mla_case(*args, qn, dev)
        worst, cworst = max(worst, err), max(cworst, cerr)
        (ms, plain_ms, lib_ms, bms, by, fbms), (cms, cplain, clib, cbms, cby,
                                                dec, onehot, cfbms) = \
            timing[qn]
        print(f"paged_mixed_attention MLA Q={qn} (S={SERVE_BATCH}, H="
              f"{MLA_HEADS}, KH=1, D=Dv={MLA_LATENT}, D2={MLA_ROPE}, page "
              f"{SERVE_PAGE}, {pps} pages/slot, bf16 pools, q_lens {q_lens}):"
              f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (D=576) "
              f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x the kernel/sdpa), bound "
              f"{bms:.4f} ms ({by}, TF32), f32 bound {fbms:.4f} ms")
        print(f"paged_mixed_attention MLA codec Q={qn}: kernel {cms:.4f} ms "
              f"(onehot {onehot:.4f} ms), plain {cplain:.4f} ms, sdpa on the "
              f"decoded f32 view {clib:.4f} ms + decode {dec:.4f} ms "
              f"({cms / (clib + dec):.2f}x kernel/(sdpa + decode)), bound "
              f"{cbms:.4f} ms ({cby}, TF32), f32 bound {cfbms:.4f} ms")
    print(f"paged_mixed_attention MLA: max abs err {worst:.3e} (fp), "
          f"{cworst:.3e} (codec) <= {ATTN_TOL} vs plain on rows i < q_lens "
          f"over Q {{64, 1}} x window {{0, 100}} x softcap {{0, "
          f"{ATTN_SOFTCAP}}}; codec gather and onehot bit-identical to the "
          f"fp kernel on the decoded f32 pools; poisoned page 0 (latent, "
          f"rope, codes, scales) inert")
    shape = (f"S=4 Q=64 H={MLA_HEADS} KH=1 D=Dv={MLA_LATENT} D2={MLA_ROPE} "
             f"page=16")
    (ms, plain_ms, lib_ms, bms, by, fbms), _ = timing[64]
    (q1, p1, l1, b1, _, fb1), (cq1, cp1, cl1, cb1, _, cd1, _, cfb1) = \
        timing[1]
    source = "src/repro_torch/csrc/paged_mla_attention.cu"
    fp = {"name": "paged_mixed_attention_mla", "route": "cuda",
          "variant_of": "paged_mixed_attention", "source": source,
          "replaces": "src/repro/kernels/paged_attention.py:239",
          "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bms, "bound_by": by, "bound_f32_ms": fbms,
          "library_ms": lib_ms,
          "shape": f"{shape} bf16 (library_ms: SDPA of q||q2 against "
                   f"c||pe, D=576, values c, on the gathered view; "
                   f"bound_ms at the TF32 tensor-core rate)",
          "decode_q1": {"ms": q1, "plain_ms": p1, "library_ms": l1,
                        "bound_ms": b1, "bound_f32_ms": fb1}}
    _, (ms, plain_ms, lib_ms, bms, by, dec_ms, onehot_ms, fbms) = timing[64]
    codec = {"name": "paged_mixed_attention_mla_codec", "route": "cuda",
             "variant_of": "paged_mixed_attention", "source": source,
             "replaces": "src/repro/kernels/paged_attention.py:239",
             "max_abs_err": cworst, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bms, "bound_by": by, "bound_f32_ms": fbms,
             "library_ms": lib_ms,
             "library_decode_ms": dec_ms, "onehot_ms": onehot_ms,
             "shape": f"{shape} int8 codes + f32 scales (library_ms: SDPA "
                      f"on the decoded f32 view, its decode in "
                      f"library_decode_ms; bound_ms at the TF32 "
                      f"tensor-core rate)",
             "decode_q1": {"ms": cq1, "plain_ms": cp1, "library_ms": cl1,
                           "bound_ms": cb1, "bound_f32_ms": cfb1,
                           "library_decode_ms": cd1}}
    return [fp, codec]


def phase_serve_mla(dev) -> dict:
    """deepseek-v2-236b at its published widths, depth cut to its two
    block kinds, served through ServeEngine + Scheduler on cuda_paged with
    fp pools and then with the codec, on one engine -> the MLA kernel's
    launches in each."""
    cfg = cut_depth(get_config(MLA_ARCH), MLA_LAYERS)
    print(f"reduced: {MLA_ARCH} depth {get_config(MLA_ARCH).num_layers} -> "
          f"{cfg.num_layers} layers ({cfg.prefix_kinds[0]} + "
          f"{cfg.scan_repeats} x {cfg.scan_pattern[0]}; widths as published:"
          f" d_model {cfg.d_model}, {cfg.num_heads} heads, kv_lora_rank "
          f"{cfg.kv_lora_rank}, q_lora_rank {cfg.q_lora_rank}, nope/rope/v "
          f"{cfg.nope_head_dim}/{cfg.rope_head_dim}/{cfg.v_head_dim}, "
          f"{cfg.num_experts} routed + {cfg.num_shared_experts} shared "
          f"experts, top-{cfg.top_k}, moe_d_ff {cfg.moe_d_ff}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, capacity "
          f"factor {cfg.capacity_factor}); reason: "
          f"{TOO_DEEP_FOR_ONE_CARD[MLA_ARCH]}; one block of each kind runs "
          f"every module of the path")
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"{MLA_ARCH} params: {nbytes / 1e9:.2f} GB on the card, random "
          f"from seed 0 in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    engine = ServeEngine(cfg, params, device=dev)
    del params
    rep = engine.report
    print(f"registration: {rep['layers']} MLP matrices "
          f"({cfg.d_model}x{cfg.d_ff}, layer 0) in "
          f"{time.monotonic() - t0:.1f}s, {rep['packed_bytes']} packed -> "
          f"{rep['stream_bytes']} stream bytes ({rep['ratio_stream']:.3f}x)")
    launches, prompts, fp_warm, toks = phase_serve(engine, mla=True)
    codec = phase_serve_codec(engine, prompts, launches, fp_warm, mla=True)
    phase_serve_paths(engine, prompts, toks, BACKEND_PATHS[:2], mla=True)
    t0 = time.monotonic()
    prefix = phase_serve_prefix_spec(engine, "serve mla", PREFIX_RUNS[1:],
                                mla=True)
    print(f"phase serve mla prefix spec: {time.monotonic() - t0:.1f}s")
    del engine
    torch.cuda.empty_cache()
    phase_decode_logits(cfg, dev, prompts, mla=True)
    t0 = time.monotonic()
    phase_verify_logits(cfg, dev, prompts, mla=True)
    print(f"phase verify logits mla: {time.monotonic() - t0:.1f}s")
    torch.cuda.empty_cache()
    return {"paged_mixed_attention_mla": launches["paged_mixed_attention_mla"],
            "paged_mixed_attention_mla_codec":
                codec["paged_mixed_attention_mla_codec"],
            "paged_mla_attention[verify]": _verify_launches(prefix)}


def _rn_blocks(cfg=rn.CONFIG):
    """(cin, cout, stride, output side) of every ReActNet-A block."""
    side = -(-cfg.image_size // 2)                   # after the stride-2 stem
    c, out = cfg.width, []
    for mult, stride in cfg.blocks:
        side = (side - 1) // stride + 1
        out.append((c, c * mult, stride, side))
        c *= mult
    return out


class _KernelSum:
    """One kernel's times, summed over the launches of one forward."""

    def __init__(self):
        self.ms = self.plain_ms = self.lib_ms = self.lib_f32_ms = 0.0
        self.t_bytes = self.t_ops = self.bound_ms = self.popc_ms = 0.0
        self.int8_ms = 0.0
        self.graph_ms = 0.0
        self.launches = 0

    def add(self, fn, plain_ms, nbytes, t_ops, lib=(0.0, 0.0)):
        """One launch of ``fn``, timed by CUDA events over eager calls and
        over a CUDA graph's replay (the event time of a short launch is the
        wrapper's host time); ``t_ops`` in seconds -> the launch's bound in
        ms."""
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, t_ops * 1e3
        ms = time_ms(fn, iters=20)
        self.last_graph_ms = graph_ms(fn)
        self.graph_ms += self.last_graph_ms
        self.ms += ms
        self.plain_ms += plain_ms
        self.lib_ms += lib[0]
        self.lib_f32_ms += lib[1]
        self.t_bytes += tb
        self.t_ops += to
        self.bound_ms += max(tb, to)
        self.launches += 1
        self.last_bound = max(tb, to)
        return max(tb, to)

    def row(self, name, source, replaces, library):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": 0.0, "ms": self.ms,
                "graph_ms": self.graph_ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": "bytes" if self.t_bytes >= self.t_ops
                else "operations",
                "library_ms": self.lib_ms if library else None}


def _merged(*sums) -> _KernelSum:
    """One kernel's times over the launches of several ``_KernelSum``s."""
    out = _KernelSum()
    for name in ("ms", "plain_ms", "lib_ms", "lib_f32_ms", "t_bytes", "t_ops",
                 "bound_ms", "popc_ms", "int8_ms", "graph_ms", "launches"):
        setattr(out, name, sum(getattr(a, name) for a in sums))
    return out


def _real(shape, gen, dev):
    """Real activations with some exact zeros (x >= 0 is bit 1 there)."""
    x = torch.randn(shape, generator=gen, device=dev)
    return torch.where(torch.rand(shape, generator=gen, device=dev) < 0.02,
                       0.0, x)


def _same(name, got, want) -> None:
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else "all"
        fail(f"{name}: kernel differs from its plain version at {bad} of "
             f"{want.numel()} outputs ({tuple(got.shape)})")


def _time_pack(acc, x, label):
    got = binarize_pack(x)
    _same(f"binarize_pack {label}", got, ref.binarize_pack(x))
    m, k = x.shape
    acc.add(lambda: binarize_pack(x),
            time_ms(lambda: ref.binarize_pack(x), iters=1, warmup=1),
            m * k * 4 + got.numel() * 4, m * k / F32_OPS_PER_S)
    return got


def _time_patches(acc, x, stride, label):
    """The patch kernel against its plain version and against the old path
    (f32 im2col columns + the (M, K) kernel), bit for bit, each timed."""
    got = binarize_pack_patches(x, stride)
    _same(f"binarize_pack_patches {label}", got,
          ref.binarize_pack_patches(x, stride))

    def old():
        return binarize_pack(ops._im2col_signs(x, stride)[0])

    _same(f"binarize_pack_patches {label} vs im2col + binarize_pack", got,
          old())
    old_ms = time_ms(old, iters=5)
    acc.add(lambda: binarize_pack_patches(x, stride),
            time_ms(lambda: ref.binarize_pack_patches(x, stride), iters=1,
                    warmup=1),
            x.numel() * 4 + got.numel() * 4, x.numel() / F32_OPS_PER_S,
            lib=(old_ms, 0.0))
    return got


def _mma_bounds(acc, m, n, kw):
    """The op bound in seconds of a +-1 product of M x N outputs over KW
    packed words on the binary tensor cores (M*N*KW*32 multiply-accumulates,
    2 ops each), the fastest way the card has; its int8 tensor-core and
    __popc (M*N*KW popcounts) bounds are added to ``acc`` beside it."""
    macs = m * n * kw * 32
    acc.int8_ms += macs * 2 / INT8_TC_OPS_PER_S * 1e3
    acc.popc_ms += m * n * kw / POPC_OPS_PER_S * 1e3
    return macs * 2 / B1_TC_OPS_PER_S


def _time_contraction(acc, xw, ww, k_true, xs, ws, label):
    """Kernel vs plain, and torch._int_mm on the +-1 int8 operands (exact
    in int32) and the f32 matmul as yardsticks."""
    got = binary_contraction(xw, ww, k_true=k_true)
    _same(f"binary_contraction {label}", got,
          ref.popcount_dot(xw, ww, k_true))
    xi, wi = xs.to(torch.int8), ws.to(torch.int8).T.contiguous()
    lib = torch._int_mm(xi, wi)
    _same(f"torch._int_mm yardstick {label}", got, lib)
    (m, kw), n = xw.shape, ww.shape[0]
    t_tc = _mma_bounds(acc, m, n, kw)
    bms = acc.add(lambda: binary_contraction(xw, ww, k_true=k_true),
                  time_ms(lambda: ref.popcount_dot(xw, ww, k_true), iters=1,
                          warmup=1),
                  (m + n) * kw * 4 + m * n * 4, t_tc,
                  lib=(time_ms(lambda: torch._int_mm(xi, wi), iters=20),
                       time_ms(lambda: xs @ ws.T, iters=20)))
    return got, bms


def _cudnn_conv_err(cin, stride, side, gen, dev) -> float:
    """Max distance from the exact integers of cuDNN's f32 conv of a
    block's +-1 input and weights (TF32 off): why the ``ste`` mode runs its
    binary convs as an im2col GEMM (exact) and not as ``F.conv2d``."""
    x = torch.where(_real((RN_BATCH, side * stride, side * stride, cin), gen,
                          dev) >= 0, 1.0, -1.0)
    w = torch.where(_real((cin, cin, 3, 3), gen, dev) >= 0, 1.0, -1.0)
    conv = torch.nn.functional.conv2d(torch.nn.functional.pad(
        x.permute(0, 3, 1, 2), (1, 1, 1, 1), value=-1.0), w, stride=stride)
    exact = ops.binary_conv3x3(x, w, stride=stride).permute(0, 3, 1, 2)
    return float((conv - exact).abs().max())


def _fused_info(comp) -> None:
    """The slab kernel's registers, spills and shared memory at each codes
    value and at ReActNet-A's smallest and largest slabs; the probe of the
    int8 and binary MMAs' rates (why the kernel runs the binary one), at
    the kernel's two blocks an SM."""
    sms = sm_count(0)
    s8, b1 = mma_rate("s8", 2 * sms), mma_rate("b1", 2 * sms)
    print(f"mma.sync probe (2 blocks of 8 warps an SM, independent MMAs "
          f"from registers): m16n8k32 s8 {s8:.1f} Tops/s "
          f"({s8 / INT8_TC_OPS_PER_S * 1e12 * 100:.1f}% of the int8 dense "
          f"peak); m16n8k256 b1 .and.popc {b1:.1f} Tops/s (x{b1 / s8:.2f}; "
          f"two-bit multiply-accumulates, 8x the k of an s8 MMA an "
          f"instruction)")
    for codes in (8, 16, 32):
        for chunked in (False, True):
            info = fused_kernel_info(codes, chunked)
            print(f"fused_decode_matmul kernel (codes {codes}, bn "
                  f"{4 * codes}, {'chunked' if chunked else 'whole'} slab): "
                  f"{info['registers']} registers a thread, "
                  f"{info['local_bytes']} local (spill) bytes")
    for i in (0, len(comp) - 1):
        words, _, meta = comp[i]
        cin, _, _, side = _rn_blocks()[i]
        plan = fused_plan(RN_BATCH * side * side, *words.shape[:3],
                          meta["codes"], sms)
        print(f"  block {i}: grid {plan.m_splits} x {words.shape[0]} blocks "
              f"of {plan.bm} rows, slab {plan.slab_tiles} of "
              f"{words.shape[1]} tiles, {plan.smem_bytes} B of dynamic "
              f"shared memory a block, {16 if plan.vec else 4}-byte "
              f"activation copies")


def _contraction_info() -> None:
    """The contraction kernel's registers and spills at each slab width,
    whole slab and chunked, and its launch plan at ReActNet-A's 26
    shapes."""
    for bn in (32, 64, 128):
        for chunked in (False, True):
            info = contraction_kernel_info(bn, chunked)
            print(f"binary_contraction kernel (slab {bn} columns, "
                  f"{'chunked' if chunked else 'whole'} slab): "
                  f"{info['registers']} registers a thread, "
                  f"{info['local_bytes']} local (spill) bytes")
    sms = sm_count(0)
    for i, (cin, cout, _, side) in enumerate(_rn_blocks()):
        m = RN_BATCH * side * side
        for conv, n, kw in (("3x3", cin, 9 * -(-cin // 32)),
                            ("1x1", cout, 9 * -(-cin // 288))):
            p = contraction_plan(m, n, kw, sms)
            print(f"  block {i:2d} {conv} M={m} N={n} KW={kw}: grid "
                  f"{p.m_splits} x {p.n_slabs} blocks of {p.bm} x {p.bn}, "
                  f"slab {p.slab_steps} of {p.steps} k steps, "
                  f"{p.smem_bytes} B of dynamic shared memory a block, "
                  f"{16 if p.vec else 4}-byte copies")


def _contraction_k_sweep(dev) -> None:
    """Graph ms of the contraction at ReActNet-A blocks 6-10's 3x3 shape (M
    6,272, N 512: 196 blocks of one M tile, all resident at once) as the
    k steps grow, with the output fixed, fitted to ``a + b * steps``: ``a``
    is a block's fixed cost (launch, slab and ring set-up, the output
    pass), ``b`` its cost a k step."""
    m, n, sms = RN_BATCH * 14 * 14, 512, sm_count(0)
    rng = np.random.default_rng(5)
    steps, times = [], []
    for kw in (8, 16, 32, 64, 96, 144):
        xw, ww = (torch.from_numpy(rng.integers(
            0, 1 << 32, (r, kw), dtype=np.uint64).astype(np.uint32).view(
                np.int32)).to(dev) for r in (m, n))
        p = contraction_plan(m, n, kw, sms)
        if p.m_splits * p.bm < m:
            fail(f"contraction k sweep: KW {kw} plans {p}, not one M tile "
                 f"a block")
        _same(f"binary_contraction ({m}, {n}) KW {kw}",
              binary_contraction(xw, ww, k_true=32 * kw),
              ref.popcount_dot(xw, ww, 32 * kw))
        steps.append(p.steps)
        times.append(graph_ms(lambda: binary_contraction(
            xw, ww, k_true=32 * kw)))
    b, a = np.polyfit(steps, times, 1)
    print(f"binary_contraction k sweep (M {m}, N {n}; graph ms by k steps "
          f"of 8 words): "
          f"{', '.join(f'{s}: {t:.4f}' for s, t in zip(steps, times))}; "
          f"fit {a:.4f} ms + {b:.5f} ms a step (the output's bytes alone "
          f"{m * n * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms)")


def phase_binary_kernels(dev, comp) -> list:
    """The BNN kernels against their plain versions, bit for bit, at the
    shapes one ReActNet-A forward at batch 32 gives them (random
    activations, the model's own compressed 3x3 weights), plus ragged
    shapes; timed with CUDA events beside their bounds."""
    _fused_info(comp)
    _contraction_info()
    _contraction_k_sweep(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    pack, pack_cols, patches = _KernelSum(), _KernelSum(), _KernelSum()
    contr3, contr1, fused = _KernelSum(), _KernelSum(), _KernelSum()
    for i, ((cin, cout, stride, side), (words, tables, meta)) in enumerate(
            zip(_rn_blocks(), comp)):
        m = RN_BATCH * side * side
        x = _real((RN_BATCH, side * stride, side * stride, cin), gen, dev)
        cols = ops._im2col_signs(x, stride)[0]
        acts = torch.where(_real((m, cin), gen, dev) >= 0, 1.0, -1.0)
        w3 = torch.where(_real((cin, 9 * cin), gen, dev) >= 0, 1.0, -1.0)
        w1 = torch.where(_real((cout, cin), gen, dev) >= 0, 1.0, -1.0)
        xw = _time_patches(patches, x, stride, f"block {i}")
        _time_pack(pack_cols, cols, f"block {i} im2col")
        packed = {"act1x1": _time_pack(pack, acts, f"block {i} act1x1")}
        pack_act_graph = pack.last_graph_ms
        packed["w1"] = _time_pack(pack, w1, f"block {i} w1")
        packed["w3"] = _time_pack(pack_cols, w3, f"block {i} w3")
        _, b3 = _time_contraction(
            contr3, xw.reshape(m, -1), packed["w3"].reshape(cin, -1),
            9 * cin, cols, w3, f"block {i} 3x3")
        del cols
        _, b1 = _time_contraction(
            contr1, packed["act1x1"].reshape(m, -1),
            packed["w1"].reshape(cout, -1), cin, acts, w1, f"block {i} 1x1")
        kw = dict(k_true=meta["k_true"], n_true=meta["n_true"],
                  codes=meta["codes"])
        got = fused_decode_matmul(words, xw, tables, **kw)
        _same(f"fused_decode_matmul block {i}", got, ref.fused_decode_matmul(
            words, xw, flat_table(tables, dev), **kw))
        lut = torch.from_numpy(pack_bitplane_tables(
            tables.cpu().numpy()).view(np.int32)).to(dev)
        _same(f"fused_decode_matmul block {i} (bit-plane table)",
              fused_decode_matmul(words, xw, lut, **kw), got)
        nb, gb = words.shape[:2]
        t_tc = _mma_bounds(fused, m, cin, gb * 9)
        fused.popc_ms += (nb * gb * meta["codes"] * 128
                          * DECODE_OPS_PER_CODE / INT32_OPS_PER_S) * 1e3
        bf = fused.add(
            lambda: fused_decode_matmul(words, xw, tables, **kw),
            time_ms(lambda: ref.fused_decode_matmul(
                words, xw, flat_table(tables, dev), **kw), iters=1, warmup=1),
            words.numel() * 4 + xw.numel() * 4 + 160 * 4 + got.numel() * 4,
            t_tc)
        cudnn_err = _cudnn_conv_err(cin, stride, side, gen, dev)
        print(f"  block {i:2d}: M={m} 3x3 K={9 * cin} N={cin}, 1x1 K={cin} "
              f"N={cout}; bounds 3x3 {b3:.4f} / 1x1 {b1:.4f} / fused "
              f"{bf:.4f} ms; graph ms: contraction 3x3 "
              f"{contr3.last_graph_ms:.4f}, 1x1 {contr1.last_graph_ms:.4f}, "
              f"fused {fused.last_graph_ms:.4f}, "
              f"patches {patches.last_graph_ms:.4f} (bound "
              f"{patches.last_bound:.4f}), 1x1 pack {pack_act_graph:.4f}; "
              f"cuDNN f32 conv of +-1 operands off the integers by "
              f"{cudnn_err:.3e}")
        del x, xw, got
    # ragged shapes: K not a multiple of 288 (nor of 9), N not of 32, M = 1
    for m, k in ((1, 1), (3, 287), (37, 289), (1, 1000), (700, 32)):
        x = _real((m, k), gen, dev)
        _same(f"binarize_pack ({m}, {k})", binarize_pack(x),
              ref.binarize_pack(x))
    for n, h, w, cin in ((2, 7, 7, 40), (2, 9, 5, 40), (1, 1, 1, 1),
                         (3, 15, 16, 96)):
        for stride in (1, 2):
            x = _real((n, h, w, cin), gen, dev)
            _same(f"binarize_pack_patches ({n}, {h}, {w}, {cin}) stride "
                  f"{stride}", binarize_pack_patches(x, stride),
                  ref.binarize_pack_patches(x, stride))
    for m, n, k in ((1, 1, 9), (1, 33, 100), (65, 70, 577), (1, 130, 16400),
                    (700, 40, 16400)):
        xw = binarize_pack(_real((m, k), gen, dev))
        w_bits = (torch.rand((n, k), generator=gen, device=dev) < 0.2)
        ww = binarize_pack(w_bits.float() - 0.5)
        _same(f"binary_contraction ({m}, {n}, {k})",
              binary_contraction(xw.reshape(m, -1), ww.reshape(n, -1),
                                 k_true=k),
              ref.popcount_dot(xw, ww, k))
        for codes in (8, 16, 32):
            for gather in ("onehot", "bitplane"):
                words, tables, meta = ops.prepare_compressed_gemm(
                    w_bits.cpu().numpy().astype(np.uint8), cluster=True,
                    gather=gather, codes=codes, device=dev)
                kw = dict(k_true=k, n_true=n, codes=codes)
                _same(f"fused_decode_matmul ({m}, {n}, {k}) codes {codes} "
                      f"{gather}", fused_decode_matmul(words, xw, tables, **kw),
                      ref.fused_decode_matmul(
                          words, xw, flat_table(tables, dev), **kw))
    # the contraction on random words (padded bits garbage): KW not a
    # multiple of 9 or 8, k_true 0, KW 0, slabs staged in K chunks (at
    # M 20,000 and 40,000 a block walks several M tiles, staging each
    # chunk again for each)
    rng = np.random.default_rng(3)
    sms = sm_count(0)
    for m, n, k, kw in ((37, 33, 400, 13), (1, 1, 5, 1), (5, 7, 0, 3),
                        (3, 5, 0, 0), (300, 129, 16400, 513),
                        (257, 40, 25000, 800), (20000, 129, 16400, 513),
                        (40000, 40, 25000, 800)):
        xw, ww = (torch.from_numpy(rng.integers(
            0, 1 << 32, (r, kw), dtype=np.uint64).astype(np.uint32).view(
                np.int32)).to(dev) for r in (m, n))
        _same(f"binary_contraction ({m}, {n}, {k}) KW {kw}",
              binary_contraction(xw, ww, k_true=k),
              ref.popcount_dot(xw, ww, k))
        p = contraction_plan(m, n, kw, sms)
        if m >= 20000 and not (p.chunked and p.m_splits < -(-m // p.bm)):
            fail(f"binary_contraction ({m}, {n}, {k}) KW {kw}: plan {p} "
                 f"does not walk several M tiles a block in K chunks")
    print(f"binary kernels: bit-exact vs their plain versions at all 13 "
          f"ReActNet-A block shapes at batch {RN_BATCH} (fused: both table "
          f"forms; patches: also vs im2col + binarize_pack) and on ragged "
          f"shapes (fused: codes 8/16/32, both tables, M = 1, K 16,400 "
          f"chunked at codes 32; contraction: also random words with "
          f"garbage padded bits at KW 13/1/3/0, k_true 0, K-chunked slabs "
          f"at KW 513/800 with one and with several M tiles a block); "
          f"torch._int_mm on +-1 int8 gives the contraction's "
          f"integers too")
    contr = _merged(contr3, contr1)
    for name, acc, extra in (
            ("binarize_pack (1x1 activations, w1)", pack, ""),
            ("binarize_pack (im2col columns, w3: the old 3x3 path)",
             pack_cols, ""),
            ("binarize_pack_patches", patches,
             f", old path (im2col + binarize_pack) {patches.lib_ms:.4f} ms"),
            *((f"binary_contraction{label}", c,
               f", int8 tensor-core bound {c.int8_ms:.4f} ms, __popc bound "
               f"{c.popc_ms:.4f} ms, torch._int_mm {c.lib_ms:.4f} ms, f32 "
               f"matmul {c.lib_f32_ms:.4f} ms")
              for label, c in ((" (3x3 convs)", contr3),
                               (" (1x1 convs)", contr1),
                               (" (all 26)", contr))),
            ("fused_decode_matmul", fused,
             f", int8 tensor-core bound {fused.int8_ms:.4f} ms, __popc + "
             f"decode bound {fused.popc_ms:.4f} ms")):
        print(f"{name}: {acc.launches} launches of one forward: kernel "
              f"{acc.ms:.4f} ms (graph {acc.graph_ms:.4f} ms), plain "
              f"{acc.plain_ms:.4f} ms, bound "
              f"{acc.bound_ms:.4f} ms (bytes {acc.t_bytes:.4f}, operations "
              f"{acc.t_ops:.4f}){extra}")
    rows = [
        pack.row("binarize_pack", "src/repro_torch/csrc/binarize_pack.cu",
                 "src/repro/kernels/binarize_pack.py:31", library=False),
        patches.row("binarize_pack_patches",
                    "src/repro_torch/csrc/binarize_pack.cu",
                    "src/repro/kernels/binarize_pack.py:31", library=False),
        contr.row("binary_contraction",
                  "src/repro_torch/csrc/binary_contraction.cu",
                  "src/repro/kernels/binary_contraction.py:49", library=True),
        fused.row("fused_decode_matmul",
                  "src/repro_torch/csrc/fused_decode_contraction.cu",
                  "src/repro/kernels/fused_decode_contraction.py:80",
                  library=False)]
    rows[0]["shape"] = (f"26 launches of a compressed forward (1x1 "
                        f"activations, w1 of 13 blocks), batch {RN_BATCH}")
    rows[0]["ms_with_old_3x3_shapes"] = pack.ms + pack_cols.ms
    rows[0]["graph_ms_with_old_3x3_shapes"] = (pack.graph_ms
                                               + pack_cols.graph_ms)
    rows[1]["shape"] = ("13 launches of a forward (3x3 conv inputs, NHWC); "
                        "with src/repro/kernels/ops.py:105 _im2col_bits")
    rows[1]["old_path_ms"] = patches.lib_ms
    rows[2]["shape"] = "26 launches of a packed forward (13 3x3 + 13 1x1)"
    rows[3]["shape"] = "13 launches of a compressed forward (3x3 convs)"
    rows[3]["int8_bound_ms"] = fused.int8_ms
    rows[3]["popc_bound_ms"] = fused.popc_ms
    for name, c, shape, path in (
            ("binary_contraction_3x3", contr3,
             "13 launches of a packed forward (3x3 convs: K 9 Cin, N Cin)",
             "packed forward less the compressed one (its 13 1x1 convs)"),
            ("binary_contraction_1x1", contr1,
             "13 launches of a packed or compressed forward (1x1 convs: K "
             "Cin, N Cout)", "compressed forward")):
        rows.append(c.row(name, "src/repro_torch/csrc/binary_contraction.cu",
                          "src/repro/kernels/binary_contraction.py:49",
                          library=True))
        rows[-1]["shape"] = shape
        rows[-1]["launches_from"] = path
    for row, c in ((rows[2], contr), (rows[4], contr3), (rows[5], contr1)):
        row["library_f32_ms"] = c.lib_f32_ms
        row["int8_bound_ms"] = c.int8_ms
        row["popc_bound_ms"] = c.popc_ms
    return rows


def setup_reactnet(dev):
    """ReActNet-A at its published shapes, random weights from seed 0, 32
    images from seed 0, and its 13 3x3 weights compressed on the host
    (``cluster=False``: lossless)."""
    cfg = rn.CONFIG
    params = rn.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (RN_BATCH, cfg.image_size, cfg.image_size, 3)).astype(
            np.float32)).to(dev)
    t0 = time.monotonic()
    comp = rn.prepare_compressed(params, cluster=False)
    print(f"reactnet-A: width {cfg.width}, {len(cfg.blocks)} blocks, "
          f"{cfg.image_size}x{cfg.image_size}, {cfg.num_classes} classes, "
          f"{cfg.dtype}, random weights from seed 0, batch {RN_BATCH}; 13 "
          f"3x3 weights compressed (cluster=False) in "
          f"{time.monotonic() - t0:.2f}s on the host; {_ratios(comp)}")
    return params, images, comp


RN_KERNELS = (binarize_pack, binarize_pack_patches, binary_contraction,
              fused_decode_matmul)


def _rn_counts() -> dict:
    return {f.__name__: f.launches for f in RN_KERNELS}


RN_EXPECT = {   # launches of one forward per conv mode (13 blocks)
    "ste": {"binarize_pack": 0, "binarize_pack_patches": 0,
            "binary_contraction": 0, "fused_decode_matmul": 0},
    "packed": {"binarize_pack": 39, "binarize_pack_patches": 13,
               "binary_contraction": 26, "fused_decode_matmul": 0},
    "compressed": {"binarize_pack": 26, "binarize_pack_patches": 13,
                   "binary_contraction": 13, "fused_decode_matmul": 13},
}


def phase_reactnet(dev, params, images, comp) -> dict:
    """ReActNet-A at full width on 32 images in every conv mode: identical
    logits, the kernels' launches, warm ms per forward; returns the
    compressed forward's launches (the paper's path), and the contraction's
    launches by shape: ``binary_contraction_1x1`` the compressed forward's
    (its 1x1 convs), ``binary_contraction_3x3`` the packed forward's less
    those (its 3x3 convs, which run in that forward only)."""
    logits, launches = {}, {}
    for mode in ("ste", "packed", "compressed"):
        cfg = dataclasses.replace(rn.CONFIG, conv_mode=mode)
        c = comp if mode == "compressed" else None
        for f in RN_KERNELS:
            f.launches = 0
        out = rn.forward(cfg, params, images, compressed=c)
        torch.cuda.synchronize()
        launches[mode] = _rn_counts()
        if launches[mode] != RN_EXPECT[mode]:
            fail(f"ReActNet {mode}: launches {launches[mode]}, expected "
                 f"{RN_EXPECT[mode]}")
        if out.shape != (RN_BATCH, 1000) or not torch.isfinite(out).all():
            fail(f"ReActNet {mode}: logits {tuple(out.shape)} not finite")
        logits[mode] = out
        t0 = time.monotonic()
        for _ in range(3):
            rn.forward(cfg, params, images, compressed=c)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) / 3 * 1e3
        print(f"reactnet {mode}: {ms:.2f} ms per forward of {RN_BATCH} "
              f"images ({RN_BATCH / ms * 1e3:.1f} images/s, warm, host clock "
              f"after synchronize); launches {launches[mode]}")
    pairs = (("packed", "ste"), ("compressed", "ste"),
             ("compressed", "packed"))
    diff = {f"{a} vs {b}": float((logits[a] - logits[b]).abs().max())
            for a, b in pairs if not torch.equal(logits[a], logits[b])}
    if diff:
        fail(f"ReActNet logits differ between modes (max abs): {diff}")
    print(f"reactnet: logits of ste, packed and compressed (cluster=False) "
          f"bit-identical; argmax {logits['ste'].argmax(-1)[:8].tolist()}...")
    for mode in ("packed", "compressed"):
        profile_reactnet(params, images, comp, mode)
    t0 = time.monotonic()
    comp_c = rn.prepare_compressed(params, cluster=True)
    host_s = time.monotonic() - t0
    out = rn.forward(dataclasses.replace(rn.CONFIG, conv_mode="compressed"),
                     params, images, compressed=comp_c)
    agree = float((out.argmax(-1) == logits["ste"].argmax(-1)).float().mean())
    print(f"reactnet compressed cluster=True: prepared in {host_s:.2f}s; "
          f"{_ratios(comp_c)}; argmax agreement with ste {agree:.4f}, max "
          f"|logit - ste| {float((out - logits['ste']).abs().max()):.4f} "
          f"(random weights: the ste argmax takes "
          f"{logits['ste'].argmax(-1).unique().numel()} distinct classes "
          f"over the batch)")
    return {**launches["compressed"],
            "binary_contraction_3x3":
                launches["packed"]["binary_contraction"]
                - launches["compressed"]["binary_contraction"],
            "binary_contraction_1x1":
                launches["compressed"]["binary_contraction"]}


def _ratios(comp) -> str:
    """Compression ratios over the 13 3x3 weights, weighted by bits."""
    bits = [m["n_true"] * m["k_true"] for _, _, m in comp]
    rs = sum(b * m["ratio_stream"] for b, (_, _, m) in zip(bits, comp))
    rt = sum(b * m["ratio_tiled"] for b, (_, _, m) in zip(bits, comp))
    return (f"ratio_stream {rs / sum(bits):.4f}, ratio_tiled "
            f"{rt / sum(bits):.4f} (bit-weighted over 13 3x3 weights; "
            f"per block stream "
            f"{[round(m['ratio_stream'], 3) for _, _, m in comp]})")


def profile_reactnet(params, images, comp, mode="compressed") -> None:
    """Where a warm forward's time goes in conv ``mode``: device busy share
    of the wall time and the top kernels by device time (profiled as
    ``tools/profile_reactnet.py`` profiles it)."""
    from torch.autograd import DeviceType
    cfg = dataclasses.replace(rn.CONFIG, conv_mode=mode)
    c = comp if mode == "compressed" else None
    wall_ms, busy, rows, averages = profile_forward(
        lambda: rn.forward(cfg, params, images, compressed=c))
    if not rows:
        print("profile reactnet: device time not measured (the profiler "
              "saw no CUDA kernels)")
        return
    print(f"profile reactnet ({mode}, warm): wall {wall_ms:.1f} ms; "
          f"device busy {busy:.1f} ms = {busy / wall_ms * 100:.1f}% of wall "
          f"(idle {100 - busy / wall_ms * 100:.1f}%); kernels by device time:")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    # the same device time by the aten op that launched it (self time, so
    # nested ops are not counted twice)
    ops_rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in averages
                if e.device_type == DeviceType.CPU
                and e.self_device_time_total > 0]
    print("  by launching op (self device time):")
    for key, ms, n in sorted(ops_rows, key=lambda r: -r[1])[:10]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")


def _exact_reactnet(cfg, seed):
    """A small ReActNet on the CPU whose float arithmetic is exact before
    the head: +-1 binary weights (alpha = 1), stem weights and images on a
    1/16 and 1/8 grid, BN variances with var + 1e-5 == 1 (BN the
    identity).  An activation within rounding of the RSign threshold can
    otherwise binarise differently on the two devices."""
    params = rn.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    params["stem"]["w"] = torch.round(params["stem"]["w"] * 16) / 16
    bns = [params["stem"]["bn"]]
    for blk in params["blocks"]:
        blk["w3"] = torch.where(blk["w3"] >= 0, 1.0, -1.0)
        blk["w1"] = torch.where(blk["w1"] >= 0, 1.0, -1.0)
        bns += [blk["bn1"], blk["bn2"]]
    for bn in bns:
        bn["var"] = torch.full_like(bn["var"], EXACT_VAR)
    gen = torch.Generator().manual_seed(seed)
    images = torch.round(torch.randn((8, cfg.image_size, cfg.image_size, 3),
                                     generator=gen) * 8) / 8
    return params, images


def phase_small_reactnet(dev) -> None:
    """A small ReActNet gives the CPU's argmax on the card, with logits
    within RN_TOL, in every conv mode."""
    cfg = dataclasses.replace(rn.CONFIG, num_classes=10, image_size=32,
                              blocks=((2, 1), (1, 2), (2, 2), (1, 1)))
    params, images = _exact_reactnet(cfg, seed=5)
    want = rn.forward(cfg, params, images)
    params_dev = tree_map(lambda t: t.to(dev), params)
    comp = rn.prepare_compressed(params_dev, cluster=False)
    worst = 0.0
    for mode in ("ste", "packed", "compressed"):
        got = rn.forward(dataclasses.replace(cfg, conv_mode=mode), params_dev,
                         images.to(dev),
                         compressed=comp if mode == "compressed" else None)
        got = got.cpu()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if not torch.equal(got.argmax(-1), want.argmax(-1)) or err > RN_TOL:
            fail(f"small ReActNet {mode}: card vs CPU max err {err}, argmax "
                 f"{got.argmax(-1).tolist()} vs {want.argmax(-1).tolist()}")
    print(f"small reactnet: (width 32, 4 blocks, 32x32, 8 images) card "
          f"ste/packed/compressed vs CPU: same argmax, max abs err "
          f"{worst:.3e} <= {RN_TOL}")


# ---------------------------------------------------------------------------
# the paper's BNN workflow: training, deploy on trained weights, checkpoint
# ---------------------------------------------------------------------------

def _check_train_step(label, prev, new, loss, grads, lr) -> None:
    """Finite loss, gradients and params; every leaf within the latent
    clip; BN running stats (no gradient in train mode) changed by the
    weight decay alone."""
    clip, wd = RN_TRAIN_OC.clip_latent, RN_TRAIN_OC.weight_decay
    if not torch.isfinite(loss):
        fail(f"{label}: loss {float(loss)}")
    for (path, g), p0, p1 in zip(_with_paths(grads), tree_leaves(prev),
                                 tree_leaves(new)):
        if not torch.isfinite(g).all() or not torch.isfinite(p1).all():
            fail(f"{label}: {path} has a non-finite gradient or value")
        if float(p1.abs().max()) > clip:
            fail(f"{label}: {path} outside the latent clip {clip}")
        if path.endswith(("/mean", "/var")):
            want = torch.clamp(p0 - lr * (wd * p0), -clip, clip)
            if g.any() or not torch.equal(p1, want):
                fail(f"{label}: BN running stat {path} changed by more than "
                     f"the weight decay")


def _with_paths(tree) -> list:
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def _small_train_step_vs_cpu(dev) -> float:
    """One training step of the small ReActNet with exact params: the
    card's loss and gradients against the CPU's."""
    cfg = dataclasses.replace(rn.CONFIG, num_classes=10, image_size=32,
                              blocks=((2, 1), (1, 2), (2, 2), (1, 1)))
    params, images = _exact_reactnet(cfg, seed=5)
    labels = torch.randint(0, cfg.num_classes, (images.shape[0],),
                           generator=torch.Generator().manual_seed(5))
    loss_c, grads_c = rn.loss_and_grads(cfg, params, {"images": images,
                                                      "labels": labels})
    loss_d, grads_d = rn.loss_and_grads(
        cfg, tree_map(lambda t: t.to(dev), params),
        {"images": images.to(dev), "labels": labels.to(dev)})
    worst = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    if worst > TRAIN_TOL:
        fail(f"small ReActNet train step: loss card {float(loss_d)} vs CPU "
             f"{float(loss_c)}")
    for (path, gc), gd in zip(_with_paths(grads_c), tree_leaves(grads_d)):
        scale = float(gc.abs().max())
        err = float((gd.cpu() - gc).abs().max())
        if scale == 0.0:
            if err:
                fail(f"small ReActNet train step: {path} has a gradient on "
                     f"the card and none on the CPU")
            continue
        worst = max(worst, err / scale)
        if err > TRAIN_TOL * scale:
            fail(f"small ReActNet train step: gradient {path} card vs CPU "
                 f"max err {err} > {TRAIN_TOL} x {scale}")
    return worst


def phase_train_reactnet(dev) -> None:
    """ReActNet-A at its published shapes trains RN_TRAIN_STEPS steps with
    the STE (the example's optimizer, synthetic 224x224 images of 1000
    classes, batch 32); then its trained weights are compressed and
    deployed in all three conv modes with bit-identical logits and
    RN_EXPECT's launches; then one step of a small model, card vs CPU."""
    cfg = rn.CONFIG
    params = rn.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    data = SyntheticImages(cfg.num_classes, cfg.image_size, RN_BATCH)
    t0 = time.monotonic()
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
               for i in range(RN_TRAIN_STEPS + 1)]
    data_s = time.monotonic() - t0
    w3_init = [blk["w3"] >= 0 for blk in params["blocks"]]
    state = opt.init_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    t0 = time.monotonic()
    for i in range(RN_TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, grads = rn.loss_and_grads(cfg, params, batches[i])
        new, state, metrics = opt.apply_updates(params, grads, state,
                                                RN_TRAIN_OC)
        end.record()
        _check_train_step(f"ReActNet-A train step {i}", params, new, loss,
                          grads, metrics["lr"])
        params = new
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    wall_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    warm = step_ms[2:]
    flips = sum(int(((blk["w3"] >= 0) != w0).sum())
                for blk, w0 in zip(params["blocks"], w3_init))
    n_w3 = sum(blk["w3"].numel() for blk in params["blocks"])
    print(f"train reactnet-A: {n_params} params, {len(cfg.blocks)} blocks, "
          f"{cfg.image_size}x{cfg.image_size}, {cfg.num_classes} classes, "
          f"batch {RN_BATCH}, ste, TF32 off; {RN_TRAIN_STEPS} steps of "
          f"SyntheticImages (made in {data_s:.2f}s on the host) in "
          f"{wall_s:.2f}s; losses {[round(x, 4) for x in losses]}")
    print(f"train reactnet-A: ms/step by CUDA events "
          f"{[round(x, 2) for x in step_ms]}; warm (steps 2-"
          f"{RN_TRAIN_STEPS - 1}) mean {sum(warm) / len(warm):.2f} ms; peak "
          f"memory {peak / 2**30:.2f} GiB (max_memory_allocated); every "
          f"loss, gradient and leaf finite, leaves within "
          f"+-{RN_TRAIN_OC.clip_latent}, BN running stats moved by weight "
          f"decay alone; w3 signs flipped {flips} of {n_w3}")

    from torch.autograd import DeviceType

    def one_step():
        loss, grads = rn.loss_and_grads(cfg, params, batches[-1])
        opt.apply_updates(params, grads, state, RN_TRAIN_OC)

    wall_ms, busy, rows, averages = profile_forward(one_step)
    if not rows:
        print("profile train step: device time not measured (the profiler "
              "saw no CUDA kernels)")
    else:
        print(f"profile train step (warm): wall {wall_ms:.1f} ms; device "
              f"busy {busy:.1f} ms = {busy / wall_ms * 100:.1f}% of wall; "
              f"kernels by device time:")
        for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")
        ops_rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in averages
                    if e.device_type == DeviceType.CPU
                    and e.self_device_time_total > 0]
        print("  by launching op (self device time):")
        for key, ms, n in sorted(ops_rows, key=lambda r: -r[1])[:8]:
            print(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")

    # --- deploy the trained weights through the kernels -------------------
    t0 = time.monotonic()
    comp = rn.prepare_compressed(params, cluster=False)
    prep_s = time.monotonic() - t0
    test = data.batch(train_example.TEST_STEP)
    images = torch.from_numpy(test["images"]).to(dev)
    logits = {}
    for mode in ("ste", "packed", "compressed"):
        for f in RN_KERNELS:
            f.launches = 0
        with torch.no_grad():
            out = rn.forward(dataclasses.replace(cfg, conv_mode=mode), params,
                             images,
                             compressed=comp if mode == "compressed" else None)
        torch.cuda.synchronize()
        if _rn_counts() != RN_EXPECT[mode]:
            fail(f"trained ReActNet-A {mode}: launches {_rn_counts()}, "
                 f"expected {RN_EXPECT[mode]}")
        if out.shape != (RN_BATCH, cfg.num_classes) or \
                not torch.isfinite(out).all():
            fail(f"trained ReActNet-A {mode}: logits {tuple(out.shape)} not "
                 f"finite")
        logits[mode] = out
    for mode in ("packed", "compressed"):
        if not torch.equal(logits[mode], logits["ste"]):
            fail(f"trained ReActNet-A: {mode} logits differ from ste by "
                 f"{float((logits[mode] - logits['ste']).abs().max())}")
    print(f"trained reactnet-A deploy: prepare_compressed(cluster=False) "
          f"{prep_s:.2f}s on the host; {_ratios(comp)}; ste, packed and "
          f"compressed logits bit-identical at batch {RN_BATCH}, launches "
          f"{RN_EXPECT['compressed']} in compressed")
    t0 = time.monotonic()
    w3 = {k: v for k, v in rn.binary_weight_bits(params).items()
          if k.endswith("w3")}
    _, rep = compression.compress_model(w3, fp_bits=rn.fp_bits(cfg, params))
    print(f"trained reactnet-A compress_model (cluster=True) "
          f"{time.monotonic() - t0:.2f}s on the host: binary ratio "
          f"{rep.binary_ratio:.4f}x, model ratio {rep.model_ratio:.4f}x "
          f"(after {RN_TRAIN_STEPS} steps, {flips / n_w3:.2%} of the "
          f"random init's w3 signs flipped: a few steps do not reach a "
          f"trained model's skew; the workflow phase trains to it)")
    worst = _small_train_step_vs_cpu(dev)
    print(f"small reactnet train step: (width 32, 4 blocks, 32x32, 8 "
          f"images, exact params) card vs CPU loss and every gradient leaf "
          f"within {worst:.3e} <= {TRAIN_TOL} of the leaf's largest element")


def phase_paper_workflow(dev) -> None:
    """``examples/torch_train_reactnet.py``'s workflow on the card: train
    PAPER_STEPS steps, deploy through the kernels, report, checkpoint
    compressed; held to ``tests/test_system.py::TestPaperWorkflow``'s
    assertions, and the checkpoint restored and redeployed."""
    with tempfile.TemporaryDirectory() as tmp:
        for f in RN_KERNELS:
            f.launches = 0
        t0 = time.monotonic()
        res = train_example.workflow(
            steps=PAPER_STEPS, batch=RN_BATCH, device=dev, ckpt_dir=tmp,
            log=lambda line: print(f"paper workflow: {line}"))
        wall_s = time.monotonic() - t0
        cfg, params, logits = res["cfg"], res["params"], res["logits"]
        # the deploy: one compressed forward without clustering, one with;
        # each kernel launches a fixed number of times a block
        want = {k: v // 13 * len(cfg.blocks) * 2
                for k, v in RN_EXPECT["compressed"].items()}
        if _rn_counts() != want:
            fail(f"paper workflow: launches {_rn_counts()}, expected {want}")
        losses, rep = res["losses"], res["report"]
        if not losses[-1] < 0.5 * losses[0]:
            fail(f"paper workflow: loss {losses[0]} -> {losses[-1]} did not "
                 f"halve")
        top64 = float(np.mean(list(res["top64"].values())))
        if not top64 > 0.3:
            fail(f"paper workflow: mean top-64 share {top64} of the trained "
                 f"w3 not above 0.3")
        if not torch.equal(logits["compressed"], logits["ste"]):
            fail("paper workflow: compressed logits differ from float-sign")
        preds = {k: v.argmax(-1) for k, v in logits.items()}
        agree = float((preds["clustered"] == preds["ste"]).float().mean())
        if not agree > 0.8:
            fail(f"paper workflow: clustered predictions agree {agree}")
        if not rep.binary_ratio > 1.1:
            fail(f"paper workflow: binary ratio {rep.binary_ratio}")
        w3 = {k: v for k, v in rn.binary_weight_bits(params).items()
              if k.endswith("w3")}
        seqs = [bitpack.kernel_to_sequences(v) for v in w3.values()]
        full = sum(huffman.full_huffman_avg_bits(
            frequency.sequence_histogram(s)) * s.size for s in seqs) / sum(
            s.size for s in seqs)
        _, plain = compression.compress_model(w3, fp_bits=0, cluster=False)
        flips = max(clustering.max_weight_flips(ct.replacement)
                    for ct in res["compressed"].values())
        if flips > 1:
            fail(f"paper workflow: clustering flips {flips} bits of a "
                 f"sequence")
        acc = res["accuracy"]
        print(f"paper workflow: {PAPER_STEPS} steps + deploy + report + "
              f"checkpoint in {wall_s:.2f}s (host clock); loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; accuracy float-sign "
              f"{acc['ste']:.4f} = compressed {acc['compressed']:.4f} "
              f"(logits bit-identical), clustered {acc['clustered']:.4f}, "
              f"clustered predictions agree {agree:.4f}; mean top-64 share "
              f"{top64:.4f}; binary ratio {rep.binary_ratio:.4f}x "
              f"(clustered), {plain.binary_ratio:.4f}x (unclustered), model "
              f"ratio {rep.model_ratio:.4f}x; avg bits a sequence: full "
              f"Huffman {full:.4f}, 4-node {9 / plain.binary_ratio:.4f}, "
              f"4-node clustered {9 / rep.binary_ratio:.4f}; max weight "
              f"flips {flips}; deploy launches {want}")
        restored, step = ckpt.restore(tmp, {"params": params}, device=dev)
    if step != PAPER_STEPS:
        fail(f"paper workflow: checkpoint step {step}")
    rparams = restored["params"]
    for i, (blk, rblk) in enumerate(zip(params["blocks"],
                                        rparams["blocks"])):
        w = blk["w3"]
        want = torch.where(w >= 0, 1.0, -1.0) * w.abs().mean(
            dim=(1, 2, 3), keepdim=True)
        if not torch.allclose(rblk["w3"], want, rtol=1e-6, atol=0.0):
            fail(f"paper workflow: restored block{i}/w3 is not sign x "
                 f"mean|w|")
    images = torch.from_numpy(
        res["data"].batch(train_example.TEST_STEP)["images"]).to(dev)
    cfg_c = dataclasses.replace(cfg, conv_mode="compressed")
    with torch.no_grad():
        out = rn.forward(cfg_c, rparams, images,
                         compressed=rn.prepare_compressed(rparams,
                                                          cluster=False))
    if not torch.equal(out.argmax(-1), preds["compressed"]):
        fail("paper workflow: the restored checkpoint's compressed forward "
             "changes predictions")
    print(f"paper workflow: compressed checkpoint (step {step}) restored on "
          f"the card; every w3 is sign x mean|w|; its compressed forward "
          f"gives the trained predictions (max |logit diff| "
          f"{float((out - logits['compressed']).abs().max()):.3e})")


# ---------------------------------------------------------------------------
# the LM trainer: gemma2-2b at full width and depth, tiny card vs CPU
# ---------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12          # H100 SXM tensor cores, bf16 dense
LM_TRAIN_ARCH = "gemma2-2b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 256, 5
# the launcher's optimizer for a run of LM_TRAIN_STEPS steps
LM_TRAIN_OC = OptConfig(lr=3e-3, warmup_steps=20,
                        total_steps=LM_TRAIN_STEPS)
# one step of the tiny config (f32, TF32 off), card vs CPU: the loss and
# each gradient leaf within TRAIN_TOL x the leaf's largest element; an
# updated param within Adam's bound for that gradient error (see
# ``_adam_bound``)
SMALL_LM_BATCH, SMALL_LM_SEQ = 4, 64
SMALL_LM_OC = OptConfig(lr=2e-2, warmup_steps=5, total_steps=60)


def lm_train_bound(cfg, batch: int, seq: int) -> tuple:
    """(operations of one forward, bytes) of a train step of a dense
    decoder (gemma2's blocks, a tied head): the matmuls' 2 x tokens x
    params of the blocks' projections and the head, plus the causal
    score and value products; a step needs 3 forwards' worth (forward,
    backward 2x) and the remat schedule does 4 (the recompute of every
    block and of the chunked CE's head); bytes: the params (bf16) and the
    two f32 moments each read and written once, and the batch."""
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = d * h * hd + 2 * d * kh * hd + h * hd * d
    mlp = (3 if cfg.mlp_act in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    tokens = batch * seq
    pairs = seq * (seq + 1) // 2
    fwd = 2 * tokens * (cfg.num_layers * (attn + mlp)
                        + d * cfg.vocab_size) \
        + cfg.num_layers * 2 * 2 * batch * h * hd * pairs
    n_params = cfg.num_layers * (attn + mlp + 4 * d) + cfg.vocab_size * d + d
    nbytes = n_params * 2 * (2 + 4 + 4) + 2 * tokens * 4
    return fwd, nbytes


def phase_train_lm(dev) -> None:
    """gemma2-2b at its published widths and full depth (26 layers, bf16,
    remat on) trains LM_TRAIN_STEPS steps of ``build_train_step`` on
    ``SyntheticLM`` from seed 0 (the launcher's optimizer): every loss
    finite; warm ms/step by CUDA events, peak memory, one profiled step's
    device busy and top kernels, beside the step's bf16 floor."""
    cfg = get_config(LM_TRAIN_ARCH)
    mesh = make_host_mesh(device=dev)
    step_fn, _ = steps_mod.build_train_step(cfg, mesh, LM_TRAIN_OC)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = steps_mod.init_train_state(
        cfg, mesh, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(state)) / 1e9
    data = SyntheticLM(cfg.vocab_size, LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=0)
    batches = [to_batch(cfg, data.batch(i), dev)
               for i in range(LM_TRAIN_STEPS + SESSIONS)]
    losses, step_ms = [], []
    for i in range(LM_TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step_fn(state, batches[i])
        end.record()
        losses.append(float(loss))
        step_ms.append(start.elapsed_time(end))
        if not np.isfinite(losses[-1]):
            fail(f"train {LM_TRAIN_ARCH}: step {i} loss {losses[-1]}")
    for path, leaf in _with_paths(state["params"]):
        if not torch.isfinite(leaf).all():
            fail(f"train {LM_TRAIN_ARCH}: {path} not finite after "
                 f"{LM_TRAIN_STEPS} steps")
    if int(state["opt"]["step"]) != LM_TRAIN_STEPS:
        fail(f"train {LM_TRAIN_ARCH}: optimizer step "
             f"{int(state['opt']['step'])}")
    peak = torch.cuda.max_memory_allocated()
    warm = step_ms[2:]
    warm_ms = sum(warm) / len(warm)
    fwd, nbytes = lm_train_bound(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    floor_ms, remat_ms = (max(n * fwd / BF16_OPS_PER_S,
                              nbytes / HBM_BYTES_PER_S) * 1e3 for n in (3, 4))
    print(f"train {LM_TRAIN_ARCH}: {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}, remat {cfg.remat}; {n_params} params, state "
          f"(params + AdamW moments) {state_gb:.2f} GB, drawn in "
          f"{init_s:.2f}s; batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} of "
          f"SyntheticLM seed 0; losses {[round(x, 4) for x in losses]}")
    print(f"train {LM_TRAIN_ARCH}: ms/step by CUDA events "
          f"{[round(x, 2) for x in step_ms]}; warm (steps 2-"
          f"{LM_TRAIN_STEPS - 1}) mean {warm_ms:.2f} ms; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated); floor "
          f"{floor_ms:.2f} ms = max({3 * fwd / 1e12:.2f} TFLOP (3 forwards) "
          f"at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16, {nbytes / 1e9:.2f} "
          f"GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s): {floor_ms / warm_ms:.1%}"
          f" of it; floor of the remat schedule (4 forwards, "
          f"{4 * fwd / 1e12:.2f} TFLOP) {remat_ms:.2f} ms: "
          f"{remat_ms / warm_ms:.1%} of it")
    it = iter(batches[LM_TRAIN_STEPS:])

    def one_step():
        nonlocal state
        state, loss = step_fn(state, next(it))
        float(loss)

    wall_ms, busy, rows, _ = profile_forward(one_step)
    if not rows:
        print("profile train step: device time not measured (the profiler "
              "saw no CUDA kernels)")
    else:
        print(f"profile train {LM_TRAIN_ARCH} step (warm): wall "
              f"{wall_ms:.1f} ms; device busy {busy:.1f} ms = "
              f"{busy / wall_ms * 100:.1f}% of wall; kernels by device "
              f"time:")
        for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    del state, batches, it
    torch.cuda.empty_cache()


def _adam_bound(grads, lr, oc) -> list:
    """Per leaf, how far one first AdamW step may move a param when its
    gradient is off by TRAIN_TOL x the leaf's largest |g|: lr * eps * s d
    / (s |g| + eps)^2 (s the global-norm clip's scale), at most 2 lr, plus
    1e-5 of the value for the update's own rounding."""
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    s = min(1.0, oc.grad_clip / max(norm, 1e-9))
    out = []
    for g in grads:
        d = TRAIN_TOL * float(g.abs().max())
        moved = lr * oc.eps * s * d / (s * g.abs() + oc.eps) ** 2
        out.append(torch.clamp(moved, max=2 * lr))
    return out


def _small_lm_step(dev) -> float:
    """One ``build_train_step`` step of the tiny gemma2 from the same
    params on the card and on the CPU: the loss and gradients within
    TRAIN_TOL, the updated params within ``_adam_bound``."""
    cfg = tiny_config(LM_TRAIN_ARCH)
    api = get_model(cfg)
    params = api.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    data = SyntheticLM(cfg.vocab_size, SMALL_LM_BATCH, SMALL_LM_SEQ, seed=1)
    step_fn, _ = steps_mod.build_train_step(cfg, {"data": 1, "model": 1},
                                            SMALL_LM_OC)
    out = {}
    for where in ("cpu", dev):
        p = tree_map(lambda t: t.to(where, copy=True), params)
        batch = to_batch(cfg, data.batch(0), where)
        _, grads = steps_mod.value_and_grad(
            lambda q: api.loss_fn(cfg, q, batch), p)
        state, loss = step_fn({"params": p, "opt": opt.init_state(p)}, batch)
        out[str(where)] = (float(loss), [g.cpu() for g in tree_leaves(grads)],
                           [t.cpu() for t in tree_leaves(state["params"])])
    (lc, gc, pc), (ld, gd, pd) = out["cpu"], out[str(dev)]
    worst = abs(ld - lc) / abs(lc)
    if worst > TRAIN_TOL:
        fail(f"small lm step: loss card {ld} vs CPU {lc}")
    for i, (a, b) in enumerate(zip(gd, gc)):
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max())
        worst = max(worst, err / scale)
        if err > TRAIN_TOL * scale:
            fail(f"small lm step: gradient leaf {i} card vs CPU {err} > "
                 f"{TRAIN_TOL} x {scale}")
    lr = float(opt.lr_schedule(SMALL_LM_OC)(torch.tensor(1)))
    moved = 0.0
    for i, (a, b, bound) in enumerate(zip(pd, pc,
                                          _adam_bound(gc, lr, SMALL_LM_OC))):
        excess = (a - b).abs() - bound - 1e-5 * b.abs() - 1e-7
        if float(excess.max()) > 0:
            fail(f"small lm step: updated leaf {i} card vs CPU beyond "
                 f"Adam's bound by {float(excess.max())}")
        moved = max(moved, float((a - b).abs().max()))
    print(f"small lm train step: tiny {LM_TRAIN_ARCH} (f32, TF32 off), one "
          f"build_train_step step card vs CPU: loss {ld:.6f} vs {lc:.6f}; "
          f"loss and every gradient leaf within {worst:.3e} <= {TRAIN_TOL} "
          f"of the leaf's largest element; updated params within Adam's "
          f"bound (max |diff| {moved:.3e}, lr {lr:.3e})")
    return worst


def _resumed_run(tmp, dev) -> None:
    """``launch.train.main`` on the card: an unbroken supervised run and
    one that dies after its checkpoint, resumed: the same losses after the
    restart, under deterministic algorithms (the embedding's and the gold
    logit gather's backward accumulate in a fixed order), bit for bit or
    failing beyond 1e-5 relative."""
    argv = ["--device", dev.type, "--steps", "12", "--batch", "4", "--seq",
            "32", "--ckpt-every", "5", "--log-every", "6"]
    real = Supervisor.run_step

    def dies_at_8(self, step_fn, state, batch, step):
        if step == 8:
            self._join()
            raise RuntimeError("host lost")
        return real(self, step_fn, state, batch, step)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        whole = train_launch.main(argv + ["--ckpt-dir", f"{tmp}/a"])
        Supervisor.run_step = dies_at_8
        try:
            train_launch.main(argv + ["--ckpt-dir", f"{tmp}/b"])
            fail("small lm resume: the broken run did not break")
        except RuntimeError as e:
            if "host lost" not in str(e):
                raise
        finally:
            Supervisor.run_step = real
        resumed = train_launch.main(argv + ["--ckpt-dir", f"{tmp}/b"])
    finally:
        torch.use_deterministic_algorithms(False)
    diff = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole[6:]))
    if len(resumed) != 6 or diff > 1e-5:
        fail(f"small lm resume: losses after the restart {resumed} vs the "
             f"unbroken run's {whole[6:]}")
    print(f"small lm resume: a 12-step supervised run on the card, "
          f"checkpoint every 5, killed at step 8 and resumed from step 5: "
          f"losses of steps 6-11 "
          + ("equal the unbroken run's bit for bit" if diff == 0 else
             f"within {diff:.3e} (relative) of the unbroken run's")
          + f" ({[round(x, 6) for x in resumed]})")


def _bf16_checkpoint(tmp, dev) -> None:
    """The tiny gemma2 in bf16 on the card: three supervised steps of
    ``build_train_step``, checkpointed (async) after each; a new
    Supervisor restores the state onto the card bit for bit in its dtypes,
    and one more step from it equals the step from the live state (under
    deterministic algorithms, as ``_resumed_run``)."""
    cfg = tiny_config(LM_TRAIN_ARCH).scaled(dtype="bfloat16")
    step_fn, _ = steps_mod.build_train_step(cfg, {"data": 1, "model": 1},
                                            SMALL_LM_OC)
    state = steps_mod.init_train_state(
        cfg, None, torch.Generator(device=dev).manual_seed(3), device=dev)
    data = SyntheticLM(cfg.vocab_size, SMALL_LM_BATCH, SMALL_LM_SEQ, seed=3)
    sup = Supervisor(FaultConfig(ckpt_dir=f"{tmp}/bf16", ckpt_every=1))
    for step in range(3):
        state, _ = sup.run_step(step_fn, state,
                                to_batch(cfg, data.batch(step), dev), step)
        sup.maybe_save(state, step)
    sup._join()
    fresh = steps_mod.init_train_state(
        cfg, None, torch.Generator(device=dev).manual_seed(4), device=dev)
    restored, start = Supervisor(sup.cfg).maybe_restore(fresh)
    dtypes = collections.Counter(str(t.dtype).split(".")[-1]
                                 for t in tree_leaves(state))
    for (path, a), b in zip(_with_paths(restored), tree_leaves(state)):
        if a.device != b.device or a.dtype != b.dtype or \
                not torch.equal(a, b):
            fail(f"bf16 checkpoint: {path} restored as {a.dtype} on "
                 f"{a.device}, not equal to the saved {b.dtype} leaf")
    batch = to_batch(cfg, data.batch(3), dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        state, want = step_fn(state, batch)
        restored, got = step_fn(restored, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    if start != 3 or float(got) != float(want) or not all(
            torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                              tree_leaves(state))):
        fail(f"bf16 checkpoint: resumed at {start}, the next step's loss "
             f"{float(got)} vs the live state's {float(want)}")
    print(f"small lm bf16 checkpoint: tiny {LM_TRAIN_ARCH} in bf16, three "
          f"supervised steps on the card checkpointed each step, restored "
          f"by a new Supervisor bit for bit ({dict(dtypes)} leaves); the "
          f"next step from it equals the live state's (loss {float(got):.6f})")


def _compressed_dp(dev) -> None:
    """``build_compressed_dp_train_step`` at one rank over NCCL (the card)
    and over gloo (the CPU), one step in each mode from the same state:
    the loss within TRAIN_TOL; params within 1e-5 and the error feedback
    within the gradient check's TRAIN_TOL x the leaf's largest |g|
    wherever the compressed level is not decided by float noise, and
    within 2 lr (params) or 2 scales (feedback) where it is.  A gradient off by
    TRAIN_TOL x the leaf's largest |g| may flip a sign where |g| is below
    that (onebit), or an int8 level where |g| / scale is within 127 x
    TRAIN_TOL of a rounding midpoint (int8)."""
    cfg = tiny_config(LM_TRAIN_ARCH)
    api = get_model(cfg)
    params = api.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    data = SyntheticLM(cfg.vocab_size, SMALL_LM_BATCH, SMALL_LM_SEQ, seed=2)
    loss_fn = lambda p, b: api.loss_fn(cfg, p, b)  # noqa: E731
    mesh = make_host_mesh(device=dev)
    lr = float(opt.lr_schedule(SMALL_LM_OC)(torch.tensor(1)))
    _, grads = steps_mod.value_and_grad(
        loss_fn, params, to_batch(cfg, data.batch(0), "cpu"))
    for mode in ("onebit", "int8"):
        out = {}
        for where in ("cpu", dev):
            step_fn, _ = steps_mod.build_compressed_dp_train_step(
                loss_fn, mesh, SMALL_LM_OC, mode=mode)
            p = tree_map(lambda t: t.to(where), params)
            state = {"params": p, "opt": opt.init_state(p),
                     "ef": init_error_feedback(p)}
            state, loss = step_fn(state, to_batch(cfg, data.batch(0), where))
            out[str(where)] = (float(loss), state)
        (lc, sc), (ld, sd) = out["cpu"], out[str(dev)]
        if abs(ld - lc) > TRAIN_TOL * abs(lc):
            fail(f"compressed dp {mode}: loss card {ld} vs CPU {lc}")
        noisy = 0
        for g, a, b, ea, eb in zip(
                tree_leaves(grads), tree_leaves(sd["params"]),
                tree_leaves(sc["params"]), tree_leaves(sd["ef"]),
                tree_leaves(sc["ef"])):
            a, ea = a.cpu(), ea.cpu()
            if mode == "onebit":
                scale = float(g.abs().mean())
                noise = g.abs() <= TRAIN_TOL * float(g.abs().max())
            else:
                scale = float(g.abs().max()) / 127
                frac = (g.abs() / max(scale, 1e-30)) % 1.0
                noise = (frac - 0.5).abs() <= 127 * TRAIN_TOL
            # the feedback carries the gradient's own error (v - level)
            for got, want, slack, atol in (
                    (a, b, 2 * lr, 1e-7),
                    (ea, eb, 2 * scale, TRAIN_TOL * float(g.abs().max()))):
                diff = (got - want).abs()
                tol = 1e-5 * want.abs() + atol
                bad = diff > tol
                noisy += int((bad & noise).sum())
                if (bad & ~noise).any() or float(diff.max()) > slack + 1e-6:
                    fail(f"compressed dp {mode}: card vs CPU differ by "
                         f"{float(diff.max())} beyond float noise")
        print(f"compressed dp {mode}: one step of build_compressed_dp_train_"
              f"step at one rank, NCCL on the card vs gloo on the CPU: loss "
              f"{ld:.6f} vs {lc:.6f}; params and error feedback within "
              f"tolerance except {noisy} elements whose level float noise "
              f"decides (within 2 lr / 2 scales there)")


def phase_small_train_lm(dev) -> None:
    """The tiny gemma2 (f32, TF32 off): one train step card vs CPU; the
    supervised launcher resumed from its checkpoint; a bf16 state through
    the Supervisor's checkpoints; the compressed DP
    step over NCCL against gloo.  Ends the world of one the phases
    started."""
    _small_lm_step(dev)
    with tempfile.TemporaryDirectory() as tmp:
        _resumed_run(tmp, dev)
        _bf16_checkpoint(tmp, dev)
    _compressed_dp(dev)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# phi3-medium-14b, h2o-danube-1.8b, gemma2-2b, mixtral-8x22b
# ---------------------------------------------------------------------------

def _arch_attention_case(dev, cfg, qn, q_lens, lengths, pps, gen,
                         **inputs) -> dict:
    """The GQA kernel at ``cfg``'s query heads, KV heads and head_dim on
    bf16 pools and on int8 codec pools: against its plain version over
    window {0, 100} x softcap {0, the arch's cap or ATTN_SOFTCAP}
    (ATTN_TOL), page 0 poisoned (inert), the codec kernel with the fp
    kernel's bits on the pools decoded up front into f32; then timed at
    window 0 with the arch's softcap (its published window, 4096, is past
    every slot of the serve phases) -> worst errors and timings.
    ``inputs``: more of ``_attn_inputs``'s arguments."""
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v, table, ln, ql = _attn_inputs(dev, qn, q_lens, lengths, pps,
                                          gen, h=h, kh=kh, d=d, **inputs)
    (kc, ks), (vc, vs) = (kv_codec.encode(x, (-2, -1)) for x in (k, v))
    cb = kv_codec.codebook(dev)
    kd, vd = decode_pool(kc, ks, cb), decode_pool(vc, vs, cb)
    ckw = dict(k_scales=ks, v_scales=vs, codebook=cb)
    pools = {"bf16": (k, v, {}), "codec": (kc, vc, ckw)}
    poison = {"bf16": (3e4, -3e4), "codec": (127, -127)}
    rows = torch.arange(qn, device=dev)[None] < ql[:, None]
    worst = {name: 0.0 for name in pools}
    for window in (0, 100):
        for cap in (0.0, cfg.attn_logit_softcap or ATTN_SOFTCAP):
            kw = dict(window=window, softcap_val=cap, page_size=SERVE_PAGE)
            fp_decoded = paged_mixed_attention(q, kd, vd, table, ln, ql,
                                               **kw)
            for name, (kk, vv, extra) in pools.items():
                got = paged_mixed_attention(q, kk, vv, table, ln, ql,
                                            **extra, **kw)
                want = paged_mixed_attention_plain(q, kk, vv, table, ln, ql,
                                                   **extra, **kw)
                kp, vp = kk.clone(), vv.clone()
                kp[0], vp[0] = poison[name]
                poisoned = paged_mixed_attention(q, kp, vp, table, ln, ql,
                                                 **extra, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs()[rows].max())
                worst[name] = max(worst[name], err)
                label = (f"{cfg.name} {name} paged attention Q={qn} "
                         f"window={window} softcap={cap}")
                if not torch.isfinite(got).all() or not err <= ATTN_TOL:
                    fail(f"{label}: max err {err} > {ATTN_TOL}")
                if not torch.equal(got, poisoned):
                    fail(f"{label}: poisoned page 0 changed the output")
                if name == "codec" and not torch.equal(got, fp_decoded):
                    fail(f"{label}: the codec kernel differs from the fp "
                         f"kernel on the decoded f32 pools at "
                         f"{int((got != fp_decoded).sum())} outputs")
    timing = {}
    kw = dict(softcap_val=cfg.attn_logit_softcap, page_size=SERVE_PAGE)
    for name, (kk, vv, extra) in pools.items():
        run = (lambda kk=kk, vv=vv, extra=extra: paged_mixed_attention(
            q, kk, vv, table, ln, ql, **extra, **kw))
        lib = _sdpa(q, kd, vd, table, ln, ql) if name == "codec" else \
            _sdpa(q, k, v, table, ln, ql)
        nbytes, ops = _attn_bytes_ops(q, kk, table, ln, ql, 0,
                                      codec=name == "codec")
        bms, by, fbms = _attn_bounds(f"{cfg.name} {name}", qn, nbytes, ops)
        timing[name] = {
            "ms": time_ms(run, iters=50), "graph_ms": graph_ms(run),
            "device_ms": device_ms(run),
            "plain_ms": time_ms(lambda: paged_mixed_attention_plain(
                q, kk, vv, table, ln, ql, **extra, **kw), iters=10),
            "library_ms": time_ms(lib, iters=50),
            "library_graph_ms": graph_ms(lib),
            "library_device_ms": device_ms(lib),
            "bound_ms": bms, "bound_by": by, "bound_f32_ms": fbms}
    return worst, timing


def phase_attention_archs(dev) -> dict:
    """The GQA kernel at each arch's decode (Q=1) and chunk (Q=64) shapes
    of the serve phases: registers, spills and shared memory, errors
    against the plain version, event and device ms beside SDPA's, TF32
    and f32 bounds -> one ``kernels`` entry an arch (launches are filled
    in from its serve)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    pps = -(-(int(SERVE_PROMPTS.max()) + SERVE_GEN) // SERVE_PAGE)
    span = pps * SERVE_PAGE
    cases = {64: ([64, 37, 0, 1], [span, 130, 0, 200]),
             1: ([1, 1, 0, 1], [span, 17, 5, 100])}
    out = {}
    for arch in ARCH_LAYERS:
        cfg = get_config(arch)
        h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        for qn in cases:
            for pools in ("bfloat16", "gather"):
                info = gqa_kernel_info(pools, SERVE_BATCH, qn, h, kh, d, d)
                print(f"paged_attention (GQA) kernel at {arch} Q={qn} "
                      f"({pools} pools, H={h}, KH={kh}, G={h // kh}, "
                      f"D=Dv={d}): {info['rows']} query rows a block, "
                      f"{info['registers']} registers a thread, "
                      f"{info['local_bytes']} local (spill) bytes, "
                      f"{info['smem_bytes']} B of dynamic shared memory")
                if info["local_bytes"]:
                    fail(f"the GQA kernel ({pools}) spills at {arch}")
        worst, timing = {}, {}
        for qn, (q_lens, lengths) in cases.items():
            worst[qn], timing[qn] = _arch_attention_case(
                dev, cfg, qn, q_lens, lengths, pps, gen)
            for name, t in timing[qn].items():
                print(f"paged_mixed_attention at {arch} Q={qn} {name} pools "
                      f"(S={SERVE_BATCH}, H={h}, KH={kh}, D={d}, softcap "
                      f"{cfg.attn_logit_softcap}, q_lens {q_lens}): kernel "
                      f"{t['ms']:.4f} ms (graph {t['graph_ms']:.4f}, device "
                      f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms,"
                      f" sdpa {t['library_ms']:.4f} ms (graph "
                      f"{t['library_graph_ms']:.4f}, device "
                      f"{t['library_device_ms']:.4f}; "
                      f"{t['graph_ms'] / t['library_graph_ms']:.2f}x "
                      f"kernel/sdpa graph); bound {t['bound_ms']:.4f} ms "
                      f"({t['bound_by']}, TF32), f32 bound "
                      f"{t['bound_f32_ms']:.4f} ms; max abs err "
                      f"{worst[qn][name]:.3e} <= {ATTN_TOL}")
        out[arch] = {
            "name": f"paged_mixed_attention[{arch}]", "route": "cuda",
            "variant_of": "paged_mixed_attention",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:239",
            "max_abs_err": max(max(w.values()) for w in worst.values()),
            **timing[64]["bf16"],
            "shape": f"S=4 Q=64 H={h} KH={kh} D={d} page=16 bf16, softcap "
                     f"{cfg.attn_logit_softcap} (bound_ms at the TF32 "
                     f"tensor-core rate; graph_ms: CUDA-graph replay; "
                     f"device_ms: profiler kernel time)",
            "decode_q1": timing[1]["bf16"], "codec": timing[64]["codec"],
            "codec_q1": timing[1]["codec"]}
    return out


@contextlib.contextmanager
def _steps_counted():
    """Count ``SlotPool.mixed_step`` calls while the block runs, by block
    width Q: every step of the kernel backend (a mixed tick, or a Q=1
    decode step after a monolithic prefill) -> Counter {Q: steps}."""
    widths = collections.Counter()
    inner = SlotPool.mixed_step

    def counted(self, params, toks, *args, **kw):
        widths[int(np.shape(toks)[1])] += 1
        return inner(self, params, toks, *args, **kw)

    SlotPool.mixed_step = counted
    try:
        yield widths
    finally:
        SlotPool.mixed_step = inner


@contextlib.contextmanager
def _calls_counted(*names):
    """Count calls of the named ``SlotPool`` methods while the block runs
    -> Counter {name: calls}."""
    calls = collections.Counter()
    inner = {n: getattr(SlotPool, n) for n in names}

    def wrap(name):
        def counted(self, *args, **kw):
            calls[name] += 1
            return inner[name](self, *args, **kw)
        return counted

    for n in names:
        setattr(SlotPool, n, wrap(n))
    try:
        yield calls
    finally:
        for n, f in inner.items():
            setattr(SlotPool, n, f)


def _kernel_blocks(pool) -> int:
    """GQA blocks whose K/V are page pools in ``pool`` (the attention
    kernel runs once each a step; the others are rolling lanes)."""
    flags, n = iter(pool.paged_flags), []
    tree_map_with_path(lambda path, leaf: n.append(
        next(flags) * (leaf.shape[0] if path.startswith("scan") else 1)),
        pool.kcache)
    return sum(n) // 2          # a GQA block's two leaves, k and v


def _arch_engine(arch, dev, table=ARCH_LAYERS):
    """``arch`` at its published widths, depth cut to ``table``'s layers,
    random weights from seed 0, registered in a ServeEngine (compressed
    when it has dense MLPs)."""
    layers, why = table[arch]
    full = get_config(arch)
    cfg = cut_depth(full, layers)
    kinds = list(cfg.prefix_kinds) + list(cfg.scan_pattern) \
        * cfg.scan_repeats + list(cfg.suffix_kinds)
    if cfg.encoder_layers:
        kinds = [f"{cfg.encoder_layers} bidir encoder"] + kinds
    if len(set(kinds)) == 1 and len(kinds) > 4:
        kinds = [f"{len(kinds)} x {kinds[0]}"]
    mlp = (f"{cfg.num_experts} experts top-{cfg.top_k}, moe_d_ff "
           f"{cfg.moe_d_ff}" if cfg.num_experts else f"d_ff {cfg.d_ff} "
           f"({cfg.mlp_act})")
    print(f"reduced: {arch} depth {full.num_layers} -> {cfg.num_layers} "
          f"layers ({' + '.join(kinds)}; widths as published: d_model "
          f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"head_dim {cfg.head_dim}, {mlp}, vocab {cfg.vocab_size}, window "
          f"{cfg.window}, softcaps {cfg.attn_logit_softcap}/"
          f"{cfg.final_logit_softcap}, {cfg.dtype}{_state_widths(cfg)}); "
          f"reason: {why}")
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"{arch} params: {nbytes / 1e9:.2f} GB on the card, random from "
          f"seed 0 in {time.monotonic() - t0:.2f}s")
    t0 = time.monotonic()
    engine = ServeEngine(cfg, params, device=dev)
    del params
    if engine.compressed:
        rep = engine.report
        print(f"registration: {rep['layers']} MLP matrices in "
              f"{time.monotonic() - t0:.1f}s, {rep['packed_bytes']} packed "
              f"-> {rep['stream_bytes']} stream bytes "
              f"({rep['ratio_stream']:.3f}x)")
    else:
        print(f"registration: {arch} has no dense MLP; served uncompressed")
    return engine


def _state_widths(cfg) -> str:
    """The published widths of an arch's recurrent or multimodal parts."""
    if cfg.family == "ssm":
        return (f", ssm heads {cfg.ssm_heads} x {cfg.ssm_head_dim}, state "
                f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, expand "
                f"{cfg.expand}")
    if cfg.family == "hybrid":
        return f", lru_width {cfg.lru_width}"
    if cfg.family == "vlm":
        return f", {cfg.num_vision_tokens} vision tokens"
    if cfg.family == "audio":
        return f", encoder_seq {cfg.encoder_seq}"
    return ""


def _serve_counted(engine, prompts, label, **kw):
    """``_serve`` from a cold tile cache (so a compressed engine's decode
    kernel runs) with the launch counts set to 0 just before it and read
    just after, and the kernel backend's steps counted: the attention
    kernel must run once a pooled block a step and never for a lane
    block; two runs give the same tokens."""
    engine.cache.clear()
    engine.metrics = ServeMetrics()
    with _steps_counted() as steps:
        _reset_counts()
        toks, wall, sched = _serve(engine, prompts, **kw)
        n_attn = _attn_launches(False)
        n_dec = huffman_decode.launches
    pool, m = sched._pool, engine.metrics
    blocks = _kernel_blocks(pool)
    n_steps = sum(steps.values())
    if n_attn != n_steps * blocks:
        fail(f"{label}: {n_attn} attention launches for {n_steps} steps "
             f"of {blocks} pooled blocks")
    if bool(n_dec) != engine.compressed:
        fail(f"{label}: {n_dec} decode launches, compressed="
             f"{engine.compressed}")
    engine.metrics = ServeMetrics()
    again, wall2, _ = _serve(engine, prompts, **kw)
    if again != toks:
        fail(f"{label}: a second run of the same requests gave other tokens")
    lanes = pool.paged_flags.count(False)
    print(f"{label}: {len(prompts)} requests, launches: attention {n_attn} "
          f"({n_steps} kernel-backend steps x {blocks} pooled blocks), "
          f"decode {n_dec}; {lanes} of {len(pool.paged_flags)} cache leaves "
          f"rolling lanes; run 1 {wall:.2f}s, {m.ms_per_token():.2f} ms/step"
          f", {m.tokens_per_s():.1f} tok/s; run 2 (warm) {wall2:.2f}s, "
          f"{engine.metrics.ms_per_token():.2f} ms/step, "
          f"{engine.metrics.tokens_per_s():.1f} tok/s; tokens identical; "
          f"sample {toks[0][:8]}")
    return n_attn, blocks, toks


def phase_serve_arch(arch, dev):
    """``arch`` at its published widths (depth cut) served on the main
    path (cuda_paged, chunk 64, page 16): every pooled block launches the
    attention kernel each step, two runs agree, a warm run profiled;
    gemma2 and danube again with the window cut to WINDOW_CUT, where
    gemma2's local blocks and every danube block are rolling lanes beside
    (or instead of) the pools: the kernel then runs for gemma2's global
    block only, and never for danube."""
    engine = _arch_engine(arch, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, engine.cfg.vocab_size, n)
               for n in SERVE_PROMPTS]
    n_attn, blocks, _ = _serve_counted(engine, prompts, f"serve {arch}")
    if blocks != engine.cfg.num_layers:
        fail(f"serve {arch}: {blocks} of {engine.cfg.num_layers} blocks "
             f"paged at the published window {engine.cfg.window}")
    prof = profile_serve(engine, prompts)
    print(f"serve {arch} warm: {prof['ms_step']:.2f} ms/step, device busy "
          f"{prof['busy_ms']:.1f} ms, attention kernel "
          f"{prof['attn_ms']:.3f} ms x{prof['attn_launches']}, one warm "
          f"materialize {prof['mat_ms']:.1f} ms")
    if arch in ("gemma2-2b", "h2o-danube-1.8b"):
        print(f"window cut: {arch} {engine.cfg.window} -> {WINDOW_CUT} "
              f"(reason: shorter than the slots, so windowed blocks keep "
              f"rolling lanes beside the page pools)")
        lane = copy.copy(engine)
        lane.cfg = engine.cfg.scaled(window=WINDOW_CUT)
        _, lane_blocks, _ = _serve_counted(
            lane, prompts, f"serve {arch} window {WINDOW_CUT}")
        want = sum(k == "global" for k in lane.cfg.scan_pattern) \
            * lane.cfg.scan_repeats
        if lane_blocks != want or (arch == "gemma2-2b") != bool(want):
            fail(f"serve {arch} window {WINDOW_CUT}: {lane_blocks} pooled "
                 f"blocks, expected {want}")
        if arch == "gemma2-2b":
            # speculation with rolling lanes beside the pools (prefix
            # sharing downgrades: a lane cannot ride a shared page)
            phase_serve_prefix_spec(lane, f"serve {arch} window {WINDOW_CUT}",
                               PREFIX_RUNS[2:])
    return engine, prompts, n_attn


def phase_archs(dev, kernels: dict, launches: dict) -> None:
    """Each arch served (``phase_serve_arch``), then one decode step's
    logits at its widths (``phase_decode_logits``; gemma2 again at
    WINDOW_CUT, lanes beside the pools)."""
    for arch in ARCH_LAYERS:
        t0 = time.monotonic()
        engine, prompts, n_attn = phase_serve_arch(arch, dev)
        launches[kernels[arch]["name"]] = n_attn
        cfg = engine.cfg.scaled(binarize_mlp=False)
        del engine
        torch.cuda.empty_cache()
        phase_decode_logits(cfg, dev, prompts, label=f"serve {arch}")
        if arch == "gemma2-2b":
            phase_decode_logits(cfg.scaled(window=WINDOW_CUT), dev, prompts,
                                label=f"serve {arch} window {WINDOW_CUT}")
        torch.cuda.empty_cache()
        print(f"phase {arch}: {time.monotonic() - t0:.1f}s")


# ---------------------------------------------------------------------------
# recurrent state lanes, the vision prefix and the encoder-decoder
# ---------------------------------------------------------------------------

def phase_attention_paligemma(dev) -> dict:
    """The GQA kernel at paligemma's decode shape (8 query heads over one
    KV head of 256, G = 8, Q = 1; the slots span the 256 vision rows, the
    longest prompt and the generated tokens): registers, spills and
    shared memory, errors against the plain version on bf16 and codec
    pools, event, graph and device ms beside SDPA's, TF32 and f32 bounds
    -> its ``kernels`` entry (launches are filled in from its serve)."""
    cfg = get_config("paligemma-3b")
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(7)
    pps = -(-(cfg.num_vision_tokens + int(SERVE_PROMPTS.max()) + SERVE_GEN)
            // SERVE_PAGE)
    q_lens, lengths = [1, 1, 0, 1], [pps * SERVE_PAGE, 300, 5, 289]
    for pools in ("bfloat16", "gather"):
        info = gqa_kernel_info(pools, SERVE_BATCH, 1, h, kh, d, d)
        print(f"paged_attention (GQA) kernel at paligemma-3b Q=1 ({pools} "
              f"pools, H={h}, KH={kh}, G={h // kh}, D=Dv={d}): "
              f"{info['rows']} query rows a block, {info['registers']} "
              f"registers a thread, {info['local_bytes']} local (spill) "
              f"bytes, {info['smem_bytes']} B of dynamic shared memory")
        if info["local_bytes"]:
            fail(f"the GQA kernel ({pools}) spills at paligemma-3b")
    worst, timing = _arch_attention_case(dev, cfg, 1, q_lens, lengths, pps,
                                         gen)
    for name, t in timing.items():
        print(f"paged_mixed_attention at paligemma-3b Q=1 {name} pools "
              f"(S={SERVE_BATCH}, H={h}, KH={kh}, D={d}, lengths {lengths}):"
              f" kernel {t['ms']:.4f} ms (graph {t['graph_ms']:.4f}, device "
              f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, sdpa "
              f"{t['library_ms']:.4f} ms (graph {t['library_graph_ms']:.4f},"
              f" device {t['library_device_ms']:.4f}); bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, TF32), f32 bound "
              f"{t['bound_f32_ms']:.4f} ms; max abs err {worst[name]:.3e} "
              f"<= {ATTN_TOL}")
    return {"name": "paged_mixed_attention[paligemma]", "route": "cuda",
            "variant_of": "paged_mixed_attention",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:239",
            "max_abs_err": max(worst.values()), **timing["bf16"],
            "shape": f"S=4 Q=1 H={h} KH={kh} D={d} page=16 bf16, lengths "
                     f"{lengths} (the vision rows included; bound_ms at "
                     f"the TF32 tensor-core rate; graph_ms: CUDA-graph "
                     f"replay; device_ms: profiler kernel time)",
            "codec_q1": timing["codec"]}


def _decode_store_layers(engine, label) -> dict:
    """Every compressed matrix shape of the engine's store decoded on the
    card, all its tiles in one launch, bit for bit against the plain
    version -> {(T, W, S, C): matrix (N x K bits)}."""
    shapes = {}
    for name, layers in engine.store.layers(engine.model_id).items():
        layer = layers[0]
        words, tables, c = layer.words, layer.tables, layer.tiled.c
        got = huffman_decode(words, tables, c=c)
        plain = ref.decode_tiled(words, tables, c)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            fail(f"{label}: huffman_decode differs from its plain version "
                 f"on {name} at {int((got != plain).sum())} codes")
        shapes[(*words.shape, c)] = f"{layer.n}x{layer.k} ({name})"
    return shapes


def phase_serve_state_arch(arch, dev) -> tuple:
    """``arch`` at its published widths (depth cut) asked for the main
    path (cuda_paged, chunk 64, page 16) and downgraded as the reference
    downgrades it (notes printed): the recurrent archs serve on the
    gathered backend with chunked prefill, paligemma on the kernel with
    monolithic prefill behind its 256 vision rows, whisper gathered and
    monolithic.  From a cold tile cache the decode kernel runs for the
    compressed archs (the store's matrices decoded bit for bit beside),
    and paligemma's attention kernel once a decode step and layer; a
    second run gives the same tokens, and so does n-gram speculation for
    the recurrent archs (proposing drafts; in f32 for ``SPEC_F32_LAYERS``,
    ``phase_spec_f32``); one warm batch is profiled -> (huffman launches,
    attention launches, decoded shapes)."""
    engine = _arch_engine(arch, dev, STATE_ARCH_LAYERS)
    cfg, label = engine.cfg, f"serve {arch}"
    t0 = time.monotonic()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_PROMPTS]
    notes = []
    engine.cache.clear()
    engine.metrics = ServeMetrics()
    with _steps_counted() as steps:
        _reset_counts()
        toks, wall, sched = _serve(engine, prompts, emit=notes.append)
        n_attn = _attn_launches(False)
        n_dec = huffman_decode.launches
    m = engine.metrics
    for note in notes:
        print(f"{label}: {note}")
    print(f"{label}: cold run {time.monotonic() - t0:.1f}s")
    vlm = cfg.family == "vlm"
    want = ("cuda_paged" if vlm else "gathered",
            None if cfg.family in ("vlm", "audio") else SERVE_CHUNK)
    if (sched.attn_backend, sched.prefill_chunk) != want:
        fail(f"{label}: served on {sched.attn_backend} with prefill_chunk "
             f"{sched.prefill_chunk}, expected {want}")
    n_steps = sum(steps.values())
    if vlm:
        blocks = _kernel_blocks(sched._pool)
        if blocks != cfg.num_layers or set(steps) != {1} or \
                n_steps != m.decode_steps or n_attn != n_steps * blocks \
                or not n_attn:
            fail(f"{label}: {n_attn} attention launches for {n_steps} Q=1 "
                 f"steps ({dict(steps)}) of {blocks} pooled blocks, "
                 f"{m.decode_steps} decode steps")
    elif n_attn or n_steps:
        fail(f"{label}: the attention kernel ran ({n_attn} launches, "
             f"{n_steps} kernel steps) on the gathered backend")
    if bool(n_dec) != engine.compressed or \
            engine.compressed != (arch != "mamba2-780m"):
        fail(f"{label}: {n_dec} decode launches, compressed="
             f"{engine.compressed}")
    shapes = _decode_store_layers(engine, label) if engine.compressed \
        else {}
    for shp, what in shapes.items():
        print(f"{label}: huffman_decode at T={shp[0]} W={shp[1]} S={shp[2]} "
              f"C={shp[3]} ({what}) bit-exact vs plain")
    engine.metrics = ServeMetrics()
    again, wall2, _ = _serve(engine, prompts, emit=notes.append)
    if again != toks:
        fail(f"{label}: a second run of the same requests gave other tokens")
    m2 = engine.metrics
    print(f"{label}: {len(prompts)} requests on {sched.attn_backend} "
          f"(prefill_chunk {sched.prefill_chunk}, slot_len "
          f"{sched._pool.slot_len}), launches: attention {n_attn} "
          f"({n_steps} kernel-backend steps x {cfg.num_layers if vlm else 0}"
          f" pooled blocks, {m.decode_steps} decode steps), decode {n_dec}; "
          f"run 1 (cold) {wall:.2f}s, {m.ms_per_token():.2f} ms/step; run 2 "
          f"(warm) {wall2:.2f}s, {m2.ms_per_token():.2f} ms/step, "
          f"{m2.tokens_per_s():.1f} tok/s; tokens identical; sample "
          f"{toks[0][:8]}")
    # one warm batch profiled, device kernels only: the recurrent archs
    # launch tens of thousands of small kernels a run
    t1 = time.monotonic()
    prof = profile_serve(engine, prompts[:SERVE_BATCH], cpu_ops=False,
                         emit=notes.append)
    print(f"serve {arch} warm (first {SERVE_BATCH} requests): "
          f"{prof['ms_step']:.2f} ms/step, device busy {prof['busy_ms']:.1f} "
          f"ms, attention kernel {prof['attn_ms']:.3f} ms "
          f"x{prof['attn_launches']}, one warm materialize "
          f"{prof['mat_ms']:.1f} ms (profiled run and its report "
          f"{time.monotonic() - t1:.1f}s)")
    if cfg.family in ("ssm", "hybrid") and arch not in SPEC_F32_LAYERS:
        engine.metrics = ServeMetrics()
        spec, wall3, _ = _serve(engine, prompts, emit=notes.append,
                                speculate="ngram", draft_k=DRAFT_K)
        ms = engine.metrics
        if spec != toks:
            fail(f"{label} ngram: other tokens than the plain run's")
        if not ms.spec_draft_tokens:
            fail(f"{label} ngram: no draft proposed, so the token check "
                 f"held nothing")
        print(f"{label} ngram (k={DRAFT_K}): tokens identical to the plain "
              f"run's; {ms.spec_accepted_tokens}/{ms.spec_draft_tokens} "
              f"drafts accepted, {ms.decode_steps} verify steps, {wall3:.2f}s"
              f", {ms.ms_per_token():.2f} ms/step")
    del engine
    torch.cuda.empty_cache()
    if arch in SPEC_F32_LAYERS:
        phase_spec_f32(arch, dev)
    return n_dec, n_attn, shapes


def phase_spec_f32(arch, dev) -> None:
    """``arch`` at its published widths in f32 (TF32 off), depth cut to
    ``SPEC_F32_LAYERS``, random weights from seed 0: greedy decoding and
    speculation, n-gram and draft-model (which proposes DRAFT_K tokens
    every round, so every verify block resumes the recurrent state and
    rolls back what it rejects), give the same tokens, and the draft model
    proposed drafts.  In bf16 the two paths round differently (the
    reference's resume branch contracts the carried f32 state in the
    activations' dtype, its one-token update in f32), and greedy ties
    between bf16 logits break either way (ROADMAP Queue 3)."""
    t0 = time.monotonic()
    cfg = cut_depth(get_config(arch), SPEC_F32_LAYERS[arch]).scaled(
        dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    engine = ServeEngine(cfg, params, device=dev)
    del params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_PROMPTS]
    notes = []
    plain, _, _ = _serve(engine, prompts, emit=notes.append)
    label, runs = f"serve {arch} f32 ({cfg.num_layers} layers)", []
    for spec in ("ngram", "draft"):
        engine.metrics = ServeMetrics()
        toks, wall, _ = _serve(engine, prompts, emit=notes.append,
                               speculate=spec, draft_k=DRAFT_K)
        m = engine.metrics
        if toks != plain:
            fail(f"{label} {spec}: other tokens than the plain run's")
        runs.append(f"{spec} {m.spec_accepted_tokens}/{m.spec_draft_tokens} "
                    f"drafts accepted in {m.spec_rounds} rounds, {wall:.2f}s")
        if spec == "draft" and not m.spec_draft_tokens:
            fail(f"{label} draft: no draft proposed")
    print(f"{label}: greedy tokens of {len(prompts)} requests identical "
          f"with speculation off, ngram and draft (k={DRAFT_K}): "
          f"{'; '.join(runs)} ({time.monotonic() - t0:.1f}s)")
    del engine
    torch.cuda.empty_cache()


def phase_state_archs(dev, launches: dict) -> dict:
    """Each of ``STATE_ARCH_LAYERS`` served (``phase_serve_state_arch``),
    then its tiny config on card and CPU on ``STATE_SMALL_PATHS`` ->
    {arch: (huffman launches, decoded shapes)}."""
    out = {}
    for arch in STATE_ARCH_LAYERS:
        t0 = time.monotonic()
        n_dec, n_attn, shapes = phase_serve_state_arch(arch, dev)
        if arch == "paligemma-3b":
            launches["paged_mixed_attention[paligemma]"] = n_attn
        out[arch] = (n_dec, shapes)
        t1 = time.monotonic()
        phase_small_reference(dev, tiny_config(arch), f"tiny {arch}",
                              paths=STATE_SMALL_PATHS)
        print(f"phase {arch}: {time.monotonic() - t0:.1f}s (tiny card vs "
              f"CPU {time.monotonic() - t1:.1f}s)")
    return out


# ---------------------------------------------------------------------------
# prefix sharing and speculative decoding
# ---------------------------------------------------------------------------

def _lcp(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _prefix_prompts(vocab: int, pattern: int = 0, seed: int = 0) -> list:
    """SERVE_PROMPTS-long prompts whose first min(PREFIX_LEN, L - 1) tokens
    are one common prefix, with tails of their own, random or tiled from
    a ``pattern``-token pattern each, as the launcher's
    ``--shared-prefix-len`` and ``--prompt-pattern`` make them."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, PREFIX_LEN)
    out = []
    for n in SERVE_PROMPTS:
        head = common[:min(PREFIX_LEN, n - 1)]
        tail_len = n - len(head)
        if pattern:
            pat = rng.integers(0, vocab, pattern)
            tail = np.tile(pat, -(-tail_len // pattern))[:tail_len]
        else:
            tail = rng.integers(0, vocab, tail_len)
        out.append(np.concatenate([head, tail]))
    return out


def _predicted_prefix(done, chunk: int, page: int) -> dict:
    """What the prefix index must map, from the prompts and the order the
    run admitted and prefilled them: each request matches the longest
    common prefix with any request whose prefill completed (and was
    registered, whole) before its admission, capped below its length and
    floored to the chunk; a registered prompt with a partial last page,
    and a match that ends inside a page, each cost one copy on write."""
    out = dict(hits=0, tokens=0, chunks=0, cow=0)
    for r in done:
        best = max((_lcp(r.prompt, q.prompt) for q in done
                    if q.t_first < r.t_admit), default=0)
        m = min(best, r.prompt_len - 1)
        m -= m % chunk
        out["hits"] += m > 0
        out["tokens"] += m
        out["chunks"] += m // chunk
        out["cow"] += bool(r.prompt_len % page) + bool(m % page)
    return out


def phase_serve_prefix_spec(engine, name, runs, mla=False) -> dict:
    """Each of ``runs`` (tag, Scheduler arguments, prompt pattern,
    profiled) on the
    main path's settings (cuda_paged, chunk 64, page 16, batch 4), from a
    cold tile cache with the launch counts set to 0 just before it and
    read just after: prefix hits, reused tokens, skipped chunks and
    copies on write equal ``_predicted_prefix``; after the drain only the
    index holds pages, one reference each; attention launches are the
    kernel backend's steps x pooled blocks exactly; the speculative
    run's drafts, acceptance and its steps at Q = 1 + DRAFT_K and Q = 1
    printed (and on rolling lanes, their snapshots and restores).  Then
    one profiled warm run of each profiled one -> {tag: attention
    launches at
    Q = 1 + DRAFT_K}."""
    out = {}
    for tag, kw, pattern, profiled in runs:
        prompts = _prefix_prompts(engine.cfg.vocab_size, pattern)
        kw = dict(kv_pages=PREFIX_PAGES, **kw)
        engine.cache.clear()
        engine.metrics = ServeMetrics()
        with _steps_counted() as widths, \
                _calls_counted("spec_snapshot", "spec_restore") as calls:
            _reset_counts()
            toks, wall, sched = _serve(engine, prompts, **kw)
            n_attn = _attn_launches(mla)
            n_dec = huffman_decode.launches
        m, pool = engine.metrics, sched._pool
        blocks = _kernel_blocks(pool)
        steps = sum(widths.values())
        label = f"{name} [{tag}]"
        if n_attn != steps * blocks or not n_dec:
            fail(f"{label}: {n_attn} attention launches for {steps} steps "
                 f"of {blocks} pooled blocks, {n_dec} decode launches")
        got = dict(hits=m.prefix_hits, tokens=m.prefix_tokens_reused,
                   chunks=m.prefill_chunks_avoided,
                   cow=m.prefix_cow_copies)
        want = _predicted_prefix(sched.completed, SERVE_CHUNK, SERVE_PAGE) \
            if sched.prefix_share else dict(hits=0, tokens=0, chunks=0,
                                            cow=0)
        if got != want or m.prefix_evictions:
            fail(f"{label}: prefix counters {got}, {m.prefix_evictions} "
                 f"evictions; the prompts predict {want}, no eviction")
        a = pool.allocator
        if pool.prefix is not None:
            if a.reserved or a.shared_pages() or \
                    a.n_allocated != pool.prefix.n_nodes or \
                    any(a.refcount(n.page) != 1
                        for n in pool.prefix._nodes()):
                fail(f"{label}: after the drain {a.n_allocated} pages "
                     f"allocated, {a.shared_pages()} shared, {a.reserved} "
                     f"reserved; the index holds {pool.prefix.n_nodes}")
            drained = (f"after the drain {a.n_allocated} pages allocated = "
                       f"the index's {pool.prefix.n_nodes} nodes, "
                       f"{a.shared_pages()} shared, mean shared pages a "
                       f"step {m.shared_page_steps / max(m.decode_steps, 1):.2f}")
        else:
            drained = "no prefix index"
        spec = kw.get("speculate", "off")
        q_spec = 1 + kw.get("draft_k", DRAFT_K)
        bad = m.spec_draft_tokens != \
            m.spec_accepted_tokens + m.spec_rejected_tokens
        bad |= spec == "off" and m.spec_rounds > 0
        bad |= spec == "draft" and not (m.spec_rounds and widths[q_spec])
        # rolling lanes are snapshotted on every tick that carries drafts
        bad |= bool(calls["spec_snapshot"]) != \
            bool(pool._lane_info and m.spec_rounds)
        if bad:
            fail(f"{label}: {m.spec_rounds} speculative rounds, "
                 f"{m.spec_draft_tokens} drafts, {widths[q_spec]} steps at "
                 f"Q={q_spec}, {calls['spec_snapshot']} lane snapshots for "
                 f"{len(pool._lane_info)} lane leaves")
        print(f"{label}: {len(prompts)} requests, prompts "
              f"{[len(p) for p in prompts]} sharing their first "
              f"min({PREFIX_LEN}, L - 1) tokens"
              f"{f', tails tiled from {pattern}-token patterns' if pattern else ''}"
              f"; prefix {got['hits']} hits, {got['tokens']} tokens reused, "
              f"{got['chunks']} chunks skipped, {got['cow']} copies on write "
              f"(predicted {want}); {drained}; launches: attention {n_attn} "
              f"({steps} kernel-backend steps x {blocks} pooled blocks), "
              f"decode {n_dec}; steps by width {dict(sorted(widths.items()))}"
              f" (Q={q_spec}: {widths[q_spec]}, Q=1: {widths[1]}); drafts "
              f"{m.spec_draft_tokens}, accepted {m.spec_accepted_tokens} "
              f"(rate {m.spec_acceptance_rate():.4f}) in {m.spec_rounds} "
              f"rounds; lane snapshots {calls['spec_snapshot']}, restores "
              f"{calls['spec_restore']}; {wall:.2f}s cold, "
              f"{m.ms_per_token():.2f} ms/step, {m.decode_steps} decode "
              f"steps for {m.tokens_generated} tokens; sample "
              f"{toks[0][:8]}")
        out[tag] = widths[q_spec] * blocks
        if not profiled:
            continue
        prof = profile_serve(engine, prompts, **kw)
        print(f"{label} warm: {prof['ms_step']:.2f} ms/step, device busy "
              f"{prof['busy_ms']:.1f} ms, attention kernel "
              f"{prof['attn_ms']:.3f} ms x{prof['attn_launches']}")
    return out


# (a)-(c) as the issue of this slice sets them; (d) drafts with the draft
# model, which proposes on every decode tick (an n-gram drafter proposes
# only when the history repeats, which a random model's tokens at a 256k
# vocabulary may never do), so the kernel runs at Q = 1 + DRAFT_K
# (tag, Scheduler arguments, prompt pattern, profiled); (d) is not
# profiled, for the script's time
PREFIX_RUNS = (
    ("a: sharing off, speculation off", {}, 0, True),
    ("b: prefix_share", dict(prefix_share=True), 0, True),
    ("c: prefix_share + speculate ngram",
     dict(prefix_share=True, speculate="ngram", draft_k=DRAFT_K), PATTERN,
     True),
    ("d: prefix_share + speculate draft",
     dict(prefix_share=True, speculate="draft", draft_k=DRAFT_K), PATTERN,
     False),
)


def _verify_launches(counts: dict) -> int:
    """Attention launches at Q = 1 + DRAFT_K over the speculative runs of
    ``phase_serve_prefix_spec`` (each counted from 0 around its run); the
    draft-model run always has some."""
    n = sum(counts.values())
    if not n:
        fail(f"no attention launch at Q = {1 + DRAFT_K}: {counts}")
    return n


def _chunk_prefill(pool, params, slot, start: int, chunk: int):
    """The slot's prompt from ``start`` on, chunk by chunk, through the
    pool's mixed step alone (every write behind the copy-on-write
    barrier, as ``Scheduler._mixed_tick`` does); the slot then ACTIVE on
    its first token."""
    req, pos = slot.req, start
    while pos < req.prompt_len:
        c = min(chunk, req.prompt_len - pos)
        toks = np.zeros((pool.n_slots, chunk), np.int32)
        poss = np.zeros(pool.n_slots, np.int32)
        q_lens = np.zeros(pool.n_slots, np.int32)
        toks[slot.index, :c] = req.prompt[pos:pos + c]
        poss[slot.index], q_lens[slot.index] = pos, c
        pool._prepare_write(slot, pos, pos + c - 1)
        pool._ensure_pages(slot, pos + c - 1)
        logits = pool.mixed_step(params, toks, poss, q_lens)
        pos += c
    slot.prefilling = False
    slot.tok = int(torch.argmax(logits[slot.index, c - 1]))
    slot.pos = req.prompt_len


def _flip_ulp(pool) -> None:
    """Flip the last bit of every bf16 value in the kernel-layout pools."""
    for leaf in tree_leaves(pool.kcache):
        if leaf.dtype != torch.bfloat16:
            fail(f"the logits check expects bf16 pools, not {leaf.dtype}")
        leaf.view(torch.int16).bitwise_xor_(1)


def phase_verify_logits(cfg, dev, prompts, mla=False) -> None:
    """Speculative verification and prefix sharing at full width, in
    ``phase_decode_logits``'s style (uncompressed bf16 MLPs, the kernel
    path, LOGIT_ULP_FACTOR times what one bf16 ulp on every cached K/V
    moves the logits, a planted one-row page shift outside it):

    * verify: four requests (prompts cut to 29, 60, 94 and 127 tokens, so
      each block crosses a page boundary, the last onto a page allocated
      for it) installed into two identical ``cuda_paged`` pools; five
      known tokens a slot scored at Q=5 in one mixed step on the first,
      and through five Q=1 steps on the second: each slot's rows within
      its own floor, and every slot's first page shifted one row must
      put some slot outside it;
    * prefix: one request prefilled in 64-token chunks and registered in
      a pool's prefix index, a second whose first 150 tokens match it
      mapped onto those pages (the partially matched page copied on
      write) and prefilled from there; against the same second request
      prefilled privately on the same chunk boundaries in a pool without
      sharing: first-decode logits within the floor."""
    name = "serve mla" if mla else "serve"
    engine = ServeEngine(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev), device=dev,
        compress=False)
    params = engine.step_params()
    engine.metrics = ServeMetrics()
    paged = dict(backend="cuda_paged", page_size=SERVE_PAGE)

    # -- verify: one Q=5 step against five Q=1 steps ----------------------
    cuts = (29, 60, 94, 127)
    reqs = [Request(i, np.asarray(p[:n], np.int32), SERVE_GEN)
            for i, (p, n) in enumerate(zip(prompts[-SERVE_BATCH:], cuts))]
    slot_len = -(-(max(cuts) + SERVE_GEN) // SLOT_LEN_QUANTUM) \
        * SLOT_LEN_QUANTUM
    firsts = [(r, *engine.prefill_request(params, r.prompt, slot_len))
              for r in reqs]
    pools = [_installed_pool(engine, params, firsts, slot_len, **paged)
             for _ in range(2)]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, 5)).astype(np.int32)
    poss = np.array([s.pos for s in pools[0].slots], np.int32)
    five, ones = np.full(SERVE_BATCH, 5, np.int32), \
        np.ones(SERVE_BATCH, np.int32)

    for pool in pools:
        for slot in pool.slots:
            pool._ensure_pages(slot, slot.pos + 4)

    def block(pool):
        return pool.mixed_step(params, toks, poss, five).float()

    def chain(pool):
        rows = []
        for i in range(5):
            rows.append(pool.mixed_step(params, toks[:, i:i + 1], poss + i,
                                        ones)[:, 0].float())
        return torch.stack(rows, 1)

    with torch.no_grad():
        q5 = block(pools[0])
        q1 = chain(pools[1])
        _flip_ulp(pools[1])
        ulp = chain(pools[1])
        for slot in range(SERVE_BATCH):
            _shift_first_page(pools[0], slot)
        fault = block(pools[0])
    # each slot against its own floor: an ulp can flip a token's expert
    # choice (deepseek's router), which moves that slot's logits alone
    floor, err, shift = ((x - q1).abs().amax(dim=(1, 2)).tolist()
                         for x in (ulp, q5, fault))
    tol = [LOGIT_ULP_FACTOR * f for f in floor]
    fmt = lambda xs: "/".join(f"{x:.4e}" for x in xs)
    print(f"{name} verify logits, uncompressed MLPs ({SERVE_BATCH} requests,"
          f" prompts {list(cuts)}, 5 tokens a slot, each block across a "
          f"page boundary): Q=5 in one mixed step vs five Q=1 steps, max "
          f"abs diff a slot {fmt(err)}; one bf16 ulp on every cached K/V "
          f"{fmt(floor)} (tolerance {LOGIT_ULP_FACTOR}x); every slot's "
          f"first page shifted one row {fmt(shift)} (worst "
          f"{max(e / t for e, t in zip(err, tol)):.3f}x tolerance; shift "
          f"up to {max(x / t for x, t in zip(shift, tol)):.2f}x)")
    if not bool(torch.isfinite(q5).all()) or not min(floor) > 0 or \
            any(e > t for e, t in zip(err, tol)):
        fail(f"{name}: Q=5 verify logits differ from five Q=1 steps by "
             f"{fmt(err)} (tolerance {fmt(tol)})")
    if not any(x > t for x, t in zip(shift, tol)):
        fail(f"{name}: the verify check does not see a planted one-row "
             f"shift ({fmt(shift)} within {fmt(tol)})")
    del pools, firsts

    # -- prefix: mapped pages against private ones ------------------------
    p0 = np.asarray(prompts[-1][:200], np.int32)
    tail = rng.integers(0, cfg.vocab_size, 30).astype(np.int32)
    tail[0] = (int(p0[150]) + 1) % cfg.vocab_size
    p1 = np.concatenate([p0[:150], tail])
    slot_len = 256
    shared = SlotPool(engine, SERVE_BATCH, slot_len, prefix_share=True,
                      **paged)
    s0 = shared.slots[0]
    s0.req = Request(0, p0, SERVE_GEN)
    shared.reserve_for(s0, s0.req)
    with torch.no_grad():
        _chunk_prefill(shared, params, s0, 0, SERVE_CHUNK)
        shared.register_prefix(s0)
        shared.retire(s0)
        s1 = shared.slots[1]
        s1.req = Request(1, p1, SERVE_GEN)
        matched = shared.map_prefix(s1, s1.req, 1)
        if matched != 150 or not shared.reserve_for(s1, s1.req):
            fail(f"{name}: the prefix check mapped {matched} tokens, not "
                 f"150")
        _chunk_prefill(shared, params, s1, matched, SERVE_CHUNK)
        private = SlotPool(engine, SERVE_BATCH, slot_len, **paged)
        t1 = private.slots[1]
        t1.req = Request(1, p1, SERVE_GEN)
        private.reserve_for(t1, t1.req)
        for lo, hi in ((0, 64), (64, 128), (128, 150)):
            t1.req.prompt, full = p1[:hi], p1
            _chunk_prefill(private, params, t1, lo, SERVE_CHUNK)
            t1.req.prompt = full
        _chunk_prefill(private, params, t1, 150, SERVE_CHUNK)
        got = shared.decode_logits(params)[1].float()
        want = private.decode_logits(params)[1].float()
        _flip_ulp(private)
        ulp = private.decode_logits(params)[1].float()
        _shift_first_page(shared, 1)
        fault = shared.decode_logits(params)[1].float()
    cow = engine.metrics.prefix_cow_copies
    floor = float((ulp - want).abs().max())
    tol = LOGIT_ULP_FACTOR * floor
    err, shift = float((got - want).abs().max()), \
        float((fault - want).abs().max())
    print(f"{name} prefix logits, uncompressed MLPs: a 180-token request "
          f"whose first {matched} tokens map {-(-matched // SERVE_PAGE)} "
          f"pages of a registered 200-token prompt ({cow} copy on write of "
          f"the partly matched page) vs the same request prefilled "
          f"privately: first-decode max abs diff {err:.4e}; one bf16 ulp "
          f"on every cached K/V {floor:.4e} (tolerance {tol:.4e}); planted "
          f"one-row shift of its first (shared) page {shift:.4e}")
    if cow != 1:
        fail(f"{name}: {cow} copies on write, expected 1")
    if not bool(torch.isfinite(got).all()) or not 0 < floor or \
            not err <= tol:
        fail(f"{name}: mapped-prefix logits differ from private ones by "
             f"{err:.4e} (tolerance {tol:.4e})")
    if not shift > tol:
        fail(f"{name}: the prefix check does not see a planted one-row "
             f"shift ({shift:.4e} <= {tol:.4e})")


def phase_attention_verify(dev) -> list:
    """The GQA and MLA kernels on verify blocks: Q=5 ragged (q_lens 5, 3,
    0, 5; each block across a page boundary, slot 3's last rows on a page
    of their own), slots 1 and 3 mapping the same two physical pages, at
    minitron's and deepseek's serving widths, against their plain
    versions (window, softcap, codec, poisoned page 0 as in the other
    cases); the GQA kernel's 16-, 32- and 64-row blocks as S grows
    (S=4 Q=5, S=12 Q=9, S=20 Q=5) -> the two ``[verify]`` entries."""
    gen = torch.Generator(device=dev).manual_seed(8)
    pps = -(-(int(SERVE_PROMPTS.max()) + SERVE_GEN) // SERVE_PAGE)
    q_lens, lengths = [5, 3, 0, 5], [pps * SERVE_PAGE, 130, 0, 36]
    cfg = get_config("minitron-8b")
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for s_n, qn in ((4, 5), (12, 9), (20, 5)):
        rows = gqa_kernel_info("bfloat16", s_n, qn, h, kh, d, d)["rows"]
        ql = [min(qn, 1 + i % qn) if i % 7 else 0 for i in range(s_n)]
        ln = [ql[i] + (i * 37) % (pps * SERVE_PAGE - qn) for i in range(s_n)]
        q, k, v, table, lns, qls = _attn_inputs(
            dev, qn, ql, ln, pps, gen, h=h, kh=kh, d=d, s_n=s_n, shared=True)
        got = paged_mixed_attention(q, k, v, table, lns, qls,
                                    page_size=SERVE_PAGE)
        want = paged_mixed_attention_plain(q, k, v, table, lns, qls,
                                           page_size=SERVE_PAGE)
        torch.cuda.synchronize()
        keep = torch.arange(qn, device=dev)[None] < qls[:, None]
        err = float((got - want).abs()[keep].max())
        print(f"paged_mixed_attention verify S={s_n} Q={qn} (ragged q_lens "
              f"{ql}, two slots on shared pages): {rows} query rows a "
              f"block, max abs err vs plain {err:.3e}")
        if not err <= ATTN_TOL:
            fail(f"verify S={s_n} Q={qn}: max abs err {err} > {ATTN_TOL}")
    worst, timing = _arch_attention_case(dev, cfg, 5, q_lens, lengths, pps,
                                         gen, shared=True)
    t = timing["bf16"]
    print(f"paged_mixed_attention[verify] (minitron widths, S=4 Q=5, q_lens "
          f"{q_lens}, lengths {lengths}, shared pages): kernel {t['ms']:.4f}"
          f" ms (graph {t['graph_ms']:.4f}, device {t['device_ms']:.4f}), "
          f"plain {t['plain_ms']:.4f} ms, sdpa device "
          f"{t['library_device_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}, TF32); max abs err {max(worst.values()):.3e}"
          f" (bf16 and codec) <= {ATTN_TOL}")
    gqa = {"name": "paged_mixed_attention[verify]", "route": "cuda",
           "variant_of": "paged_mixed_attention",
           "source": "src/repro_torch/csrc/paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention.py:239",
           "max_abs_err": max(worst.values()), **t,
           "shape": f"S=4 Q=5 q_lens {q_lens} H={h} KH={kh} D={d} page=16 "
                    f"bf16, slots 1 and 3 on shared pages (bound_ms at the "
                    f"TF32 tensor-core rate; launches: the speculative "
                    f"serve's steps at Q=5 x blocks)",
           "codec": timing["codec"]}
    args = _mla_inputs(dev, 5, q_lens, lengths, pps, gen)
    q, c, q2, pe, table, ln, ql = args
    table[3, :2] = table[1, :2]
    err, cerr, ((ms, plain_ms, lib_ms, bms, by, fbms), ctiming) = \
        _mla_case(*args, 5, dev)
    kw = dict(scale=MLA_SCALE, page_size=SERVE_PAGE)
    run = lambda: paged_mixed_attention(q, c, c, table, ln, ql, q2, pe, **kw)
    lib = _sdpa(torch.cat([q, q2], -1), torch.cat([c, pe], -1), c, table,
                ln, ql, scale=MLA_SCALE)
    g_ms, d_ms, lib_d_ms = graph_ms(run), device_ms(run), device_ms(lib)
    print(f"paged_mla_attention[verify] (deepseek widths, S=4 Q=5, same "
          f"q_lens and shared pages): kernel {ms:.4f} ms (graph {g_ms:.4f}, "
          f"device {d_ms:.4f}), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
          f"ms (device {lib_d_ms:.4f}); bound {bms:.4f} ms ({by}, TF32); "
          f"max abs err {err:.3e} (fp), {cerr:.3e} (codec) <= {ATTN_TOL}")
    mla = {"name": "paged_mla_attention[verify]", "route": "cuda",
           "variant_of": "paged_mixed_attention",
           "source": "src/repro_torch/csrc/paged_mla_attention.cu",
           "replaces": "src/repro/kernels/paged_attention.py:239",
           "max_abs_err": max(err, cerr), "ms": ms, "graph_ms": g_ms,
           "device_ms": d_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_device_ms": lib_d_ms, "bound_ms": bms, "bound_by": by,
           "bound_f32_ms": fbms,
           "shape": f"S=4 Q=5 q_lens {q_lens} H={MLA_HEADS} KH=1 "
                    f"D={MLA_LATENT} D2={MLA_ROPE} page=16 bf16, slots 1 "
                    f"and 3 on shared pages (library_ms: SDPA of q||q2 "
                    f"against c||pe; launches: the speculative serve's "
                    f"steps at Q=5 x blocks)"}
    return [gqa, mla]


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.monotonic()

    def timed(label, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        print(f"phase {label}: {time.monotonic() - t0:.1f}s", flush=True)
        return out

    timed("build", phase_build)
    engine, expect = timed("register minitron", phase_register, dev)
    kernels = [timed("huffman", phase_huffman, engine, expect),
               *timed("attention", phase_attention, dev)]
    # before the serve phases: late in a run the profiler has been seen to
    # drop part of this kernel's time (graph ms unchanged)
    arch_kernels = timed("attention archs", phase_attention_archs, dev)
    kernels.append(timed("attention paligemma", phase_attention_paligemma,
                         dev))
    kernels += timed("attention verify", phase_attention_verify, dev)
    launches, prompts, fp_warm, toks = timed("serve minitron", phase_serve,
                                             engine)
    timed("serve telemetry", phase_serve_telemetry, engine, prompts, toks,
          launches)
    timed("cache auto", phase_cache_auto, engine, prompts, toks, launches)
    codec_launches = timed("serve minitron codec", phase_serve_codec,
                           engine, prompts, launches, fp_warm)
    launches["paged_mixed_attention_codec"] = \
        codec_launches["paged_mixed_attention_codec"]
    timed("fused operands", phase_fused_operands, engine, dev)
    timed("serve paths", phase_serve_paths, engine, prompts, toks,
          BACKEND_PATHS)
    prefix = timed("serve prefix spec", phase_serve_prefix_spec, engine,
                   "serve", PREFIX_RUNS)
    launches["paged_mixed_attention[verify]"] = _verify_launches(prefix)
    cfg = engine.cfg.scaled(binarize_mlp=False)
    del engine
    torch.cuda.empty_cache()
    timed("decode logits", phase_decode_logits, cfg, dev, prompts)
    timed("verify logits", phase_verify_logits, cfg, dev, prompts)
    torch.cuda.empty_cache()
    kernels += timed("attention mla", phase_attention_mla, dev)
    timed("decode wrapper", phase_decode_wrapper, dev)
    launches.update(timed("serve mla", phase_serve_mla, dev))
    timed("small mla", phase_small_mla_reference, dev)
    timed("small minitron", phase_small_reference, dev,
          tiny_config("minitron-8b"), "tiny minitron", True)
    timed("archs", phase_archs, dev, arch_kernels, launches)
    kernels += list(arch_kernels.values())
    for arch in ARCH_LAYERS:
        timed(f"small {arch}", phase_small_reference, dev,
              tiny_config(arch), f"tiny {arch}")
    timed("small gemma2 lanes", phase_small_reference, dev,
          tiny_config("gemma2-2b").scaled(window=16),
          "tiny gemma2-2b at window 16 (local blocks rolling lanes beside "
          "the pools)", True)
    state = timed("state archs", phase_state_archs, dev, launches)
    kernels[0]["launches_by_arch"] = {a: n for a, (n, _) in state.items()
                                      if n}
    kernels[0]["arch_shapes"] = {
        a: [f"T={t} W={w} S={sz} C={c}: {what}"
            for (t, w, sz, c), what in shapes.items()]
        for a, (_, shapes) in state.items() if shapes}
    params, images, comp = timed("setup reactnet", setup_reactnet, dev)
    kernels += timed("binary kernels", phase_binary_kernels, dev, comp)
    launches.update(timed("reactnet", phase_reactnet, dev, params, images,
                          comp))
    timed("small reactnet", phase_small_reactnet, dev)
    del params, images, comp
    torch.cuda.empty_cache()
    timed("train reactnet", phase_train_reactnet, dev)
    timed("paper workflow", phase_paper_workflow, dev)
    timed("train lm", phase_train_lm, dev)
    timed("small train lm", phase_small_train_lm, dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"total {time.monotonic() - t_start:.1f}s; gpu: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
