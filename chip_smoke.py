#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card at the
shapes the serving path gives it, then serves minitron-8b at its
published widths (depth cut to 2 layers) through ``ServeEngine`` and
``Scheduler`` on the ``cuda_paged`` backend, and checks that both kernels
were launched by that run, that every request completed with finite
logits, that a second run gives the same tokens, and that a small model
served on the card gives the same tokens as on the CPU.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before them, as does a machine without a GPU.
Peak rates for the roofline bounds are the H100 SXM data-sheet numbers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import bitpack  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.huffman_decode import huffman_decode  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_mixed_attention, paged_mixed_attention_plain)
from repro_torch.launch.serve import tiny_config  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.runtime import Scheduler, ServeEngine, ServeMetrics  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_OPS_PER_S = 67e12            # H100 SXM CUDA cores, an FMA counted as 2
# int32 issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost, one op per
# lane per clock -- a quarter of the f32 rate (half the lanes, no FMA pair)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
DECODE_OPS_PER_CODE = 25         # integer ops per decoded code (see .cu)
ATTN_TOL = 1e-4                  # kernel vs plain, bf16 pools: both score
#                                  in f32 from the same bf16 values, so they
#                                  differ in f32 summation order and the
#                                  exp/tanh implementations only
ATTN_SOFTCAP = 4.0               # near the score scale, so a kernel that
#                                  skipped the cap would fail the check

# serve phase: minitron-8b widths, depth cut for host-side compression
SERVE_LAYERS = 2
SERVE_BATCH, SERVE_CHUNK, SERVE_PAGE, SERVE_GEN = 4, 64, 16, 16
SERVE_PROMPTS = np.linspace(32, 256, 8).astype(int)


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
          f"{cfg.d_model}x{cfg.d_ff} MLP matrix on the host (~10 s each), "
          f"and full depth has {2 * 32} of them")
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
    plain_ms = time_ms(lambda: ref.decode_tiled(words, tables, c), iters=5)
    nbytes = words.numel() * 4 + tables.numel() * 4 + got.numel() * 4
    bms, by = bound_ms(nbytes, DECODE_OPS_PER_CODE * got.numel(),
                       INT32_OPS_PER_S)
    t, w, s = words.shape
    print(f"huffman_decode: (T={t}, W={w}, S={s}) -> C={c}, one full-width "
          f"matrix ({layer.n}x{layer.k} bits); bit-exact vs plain and vs "
          f"the registered bits; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {bms:.4f} ms ({by})")
    return {"name": "huffman_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/huffman_decode.cu",
            "replaces": "src/repro/kernels/huffman_decode.py:112",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"T={t} W={w} S={s} C={c}"}


def _attn_inputs(dev, qn, q_lens, lengths, pps, gen):
    s_n, h, kh, d, page = SERVE_BATCH, 32, 8, 128, SERVE_PAGE
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
    q = torch.randn((s_n, qn, h, d), generator=gen, device=dev) * d ** -0.5
    as_i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    return q, k, v, table, as_i32(lengths), as_i32(q_lens)


def _attn_bytes_ops(q, k, table, lengths, q_lens, window):
    """Bytes every input read once + output written once, and f32 ops,
    for what these inputs need (positions each slot's tokens can see)."""
    _, qn, h, d = q.shape
    kh = k.shape[2]
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
    nbytes = (q.numel() * 4 + kv_pos * kh * 2 * d * k.element_size()
              + table.numel() * 4 + 2 * lengths.numel() * 4
              + q.numel() * 4)
    ops = pairs * h * (4 * d + 6)     # q.k, p.v, online-softmax update
    return nbytes, ops


def _sdpa_ms(q, k, v, table, lengths, q_lens) -> float:
    """One torch SDPA call over the gathered per-slot view (yardstick
    only; the port never calls it)."""
    import torch.nn.functional as F
    s_n, qn, h, d = q.shape
    kh = k.shape[2]
    span = table.shape[1] * k.shape[1]
    kg = k[table.long()].reshape(s_n, span, kh, d).repeat_interleave(
        h // kh, dim=2).transpose(1, 2)
    vg = v[table.long()].reshape(s_n, span, kh, d).repeat_interleave(
        h // kh, dim=2).transpose(1, 2)
    qg = q.to(torch.bfloat16).transpose(1, 2)
    qpos = (lengths - q_lens)[:, None] + torch.arange(qn, device=q.device)
    mask = torch.arange(span, device=q.device)[None, None] <= qpos[..., None]
    mask = mask[:, None]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=mask, scale=1.0), iters=50)


def phase_attention(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    pps = -(-(int(SERVE_PROMPTS.max()) + SERVE_GEN) // SERVE_PAGE)
    span = pps * SERVE_PAGE
    cases = {   # Q: (q_lens, lengths) — ragged, incl. an empty slot
        64: ([64, 37, 0, 1], [span, 130, 0, 200]),
        1: ([1, 1, 0, 1], [span, 17, 5, 100]),
    }
    worst, timing = 0.0, {}
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
        bms, by = bound_ms(*_attn_bytes_ops(q, k, table, ln, ql, 0))
        timing[qn] = (ms, plain_ms, lib_ms, bms, by)
        print(f"paged_mixed_attention Q={qn} (S={SERVE_BATCH}, H=32, KH=8, "
              f"D=128, page {SERVE_PAGE}, {pps} pages/slot, bf16 pools, "
              f"q_lens {q_lens}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    print(f"paged_mixed_attention: max abs err {worst:.3e} <= {ATTN_TOL} "
          f"on rows i < q_lens over Q {{64, 1}} x window {{0, 100}} x "
          f"softcap {{0, {ATTN_SOFTCAP}}}; poisoned page 0 inert")
    ms, plain_ms, lib_ms, bms, by = timing[64]
    return {"name": "paged_mixed_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:239",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "shape": "S=4 Q=64 H=32 KH=8 D=128 page=16 bf16",
            "decode_q1": {"ms": timing[1][0], "plain_ms": timing[1][1],
                          "library_ms": timing[1][2],
                          "bound_ms": timing[1][3]}}


def _serve(engine, prompts):
    sched = Scheduler(engine, batch_size=SERVE_BATCH,
                      prefill_chunk=SERVE_CHUNK, kv_page_size=SERVE_PAGE,
                      attn_backend="cuda_paged")
    for p in prompts:
        sched.submit(p, SERVE_GEN)
    t0 = time.monotonic()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if len(done) != len(prompts) or \
            any(len(r.generated) != SERVE_GEN for r in done):
        fail("not every request completed with its full token budget")
    return {r.rid: tuple(r.generated) for r in done}, wall


def phase_serve(engine) -> dict:
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, engine.cfg.vocab_size, n)
               for n in SERVE_PROMPTS]
    engine.metrics = ServeMetrics()
    huffman_decode.launches = 0
    paged_mixed_attention.launches = 0
    toks1, wall1 = _serve(engine, prompts)
    launches = {"huffman_decode": huffman_decode.launches,
                "paged_mixed_attention": paged_mixed_attention.launches}
    m1, st1 = engine.metrics, engine.cache.stats()
    if not all(launches.values()):
        fail(f"the serve run did not launch every kernel: {launches}")
    engine.metrics = ServeMetrics()
    toks2, wall2 = _serve(engine, prompts)
    m2 = engine.metrics
    if toks1 != toks2:
        fail("a second run of the same requests gave other tokens")
    st = engine.cache.stats()
    print(f"serve: {len(prompts)} requests, prompts {SERVE_PROMPTS.tolist()}"
          f", gen {SERVE_GEN}, batch {SERVE_BATCH}, chunk {SERVE_CHUNK}, "
          f"page {SERVE_PAGE}, cuda_paged; launches {launches}")
    print(f"serve run 1 (cold tile cache): {wall1:.2f}s, "
          f"{m1.ms_per_token():.2f} ms/step, {m1.tokens_per_s():.1f} tok/s, "
          f"hit rate {st1['hit_rate'] * 100:.1f}% ({st1['misses']} misses)")
    print(f"serve run 2 (warm): {wall2:.2f}s, {m2.ms_per_token():.2f} "
          f"ms/step, {m2.tokens_per_s():.1f} tok/s; cumulative tile-cache "
          f"hit rate {st['hit_rate'] * 100:.1f}%; tokens identical to run 1")
    print(f"serve kv gather bytes: {m2.kv_gather_bytes} decode, "
          f"{m2.kv_prefill_gather_bytes} prefill; sample {toks1[0][:8]}")
    if m2.kv_gather_bytes or m2.kv_prefill_gather_bytes:
        fail("the mixed-step path copied KV")
    profile_serve(engine, prompts)
    return launches


def profile_serve(engine, prompts) -> None:
    """Where a warm serve run's time goes: one more run of the same
    requests under torch.profiler -> device busy share of the wall time
    and the kernels by device time; plus the host cost of one warm
    ``materialize`` (every tile a cache hit)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.monotonic()
    engine.step_params()
    mat_ms = (time.monotonic() - t0) * 1e3
    hits0 = engine.cache.hits
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _serve(engine, prompts)
        wall_ms = (time.monotonic() - t0) * 1e3
    calls = (engine.cache.hits - hits0) // engine.store.n_tiles(
        engine.model_id)
    # kernel rows only: an aten op's row repeats its kernels' device time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    print(f"profile (warm run): wall {wall_ms:.1f} ms; {calls} materialize "
          f"calls (one per tick and per admission); one warm materialize, "
          f"timed alone, {mat_ms:.1f} ms on the host")
    if not rows:
        print("profile: device time not measured (the profiler saw no "
              "CUDA kernels)")
        return
    print(f"profile: device busy {busy:.1f} ms = {busy / wall_ms * 100:.1f}% "
          f"of wall (idle {100 - busy / wall_ms * 100:.1f}%)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")


def phase_small_reference(dev) -> None:
    """A small model served on the card gives the CPU's tokens.  Its MLP
    weights are +-1 (unit scale), so every binarised product is an exact
    integer on either device; with other scales, a unit whose +-alpha
    terms cancel exactly is rounding noise whose sign follows the BLAS's
    summation order (as it does in the JAX reference)."""
    cfg = tiny_config("minitron-8b")
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for name, w in params["scan"]["b0"]["mlp"].items():
        params["scan"]["b0"]["mlp"][name] = torch.where(w >= 0, 1.0, -1.0)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab_size, n), g)
            for n, g in ((5, 7), (12, 2), (20, 5), (6, 9), (3, 1), (9, 4))]
    out = {}
    for device in ("cpu", dev):
        engine = ServeEngine(cfg, params, device=device)
        sched = Scheduler(engine, batch_size=2, prefill_chunk=3,
                          kv_page_size=4, attn_backend="cuda_paged")
        for r in reqs:
            sched.submit(*r)
        out[str(device)] = {r.rid: tuple(r.generated) for r in sched.run()}
    if out["cpu"] != out[str(dev)]:
        fail(f"tiny model on the card gave other tokens than on the CPU: "
             f"{out}")
    print(f"small reference: tiny minitron ({cfg.d_model} wide, f32) "
          f"serves {len(reqs)} requests to identical tokens on cuda and "
          f"cpu")


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
    phase_build()
    engine, expect = phase_register(dev)
    kernels = [phase_huffman(engine, expect), phase_attention(dev)]
    launches = phase_serve(engine)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    del engine
    torch.cuda.empty_cache()
    phase_small_reference(dev)
    print(f"total {time.monotonic() - t_start:.1f}s; gpu: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
