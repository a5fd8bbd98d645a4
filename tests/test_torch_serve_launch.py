"""The port's serve launcher reads argv as the reference's does, on the CPU.

The same argv lists go through ``repro.launch.serve.main`` and
``repro_torch.launch.serve.main`` (plus ``--device cpu``, a flag of the
port only) with the engine and the scheduler replaced by recorders: both
must build the same model config, hand the scheduler the same settings
(the backend ``pallas_paged`` read as ``cuda_paged``; prefix sharing,
speculation and the draft depth included) and submit the same prompts
(a shared prefix from ``--shared-prefix-len``, tails tiled from
``--prompt-pattern``).  Omitted flags mean the reference's defaults:
gemma2-2b, the ``gathered`` backend, monolithic prefill and monolithic
lanes, no sharing, no speculation.  ``cuda_paged`` without a page size
raises, as the reference's ``pallas_paged`` does, and the port's
scheduler still refuses the kernel autotuner.  The telemetry flags
(``--trace-out``, ``--trace-jsonl``, ``--metrics-out``) give both engines
the same recorder (tracing or histograms only), and ``--cache-mb`` the
same capacity, or under ``auto`` the capacity the autotuner returns
(their argv lists: ``tests/test_torch_serve_launch_flags.py``).
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

import repro.launch.serve as jax_launch
from repro.runtime import Scheduler as JaxScheduler
from repro_torch.launch import serve as serve_launch
from repro_torch.models.transformer import init_params
from repro_torch.runtime import Scheduler, ServeEngine

# the settings both launchers hand the scheduler
SETTINGS = ("batch_size", "mode", "prefill_chunk", "prefill_budget",
            "kv_page_size", "kv_pages", "attn_backend", "kv_codec",
            "prefix_share", "speculate", "draft_k", "log_every")

ARGVS = [
    [],
    ["--kv-page-size", "8"],
    ["--prefill-chunk", "4"],
    ["--prefill-chunk", "16", "--kv-page-size", "16"],
    ["--attn-backend", "{paged}", "--kv-page-size", "16"],
    ["--attn-backend", "{paged}", "--kv-page-size", "16", "--prefill-chunk",
     "16"],
    ["--attn-backend", "{paged}", "--kv-page-size", "4", "--prefill-chunk",
     "8", "--prefill-budget", "16", "--kv-pages", "40", "--kv-codec",
     "cluster"],
    ["--mode", "wave", "--batch", "2", "--log-every", "4"],
    ["--arch", "h2o-danube-1.8b", "--kv-page-size", "4"],
    ["--arch", "mixtral-8x22b", "--attn-backend", "{paged}",
     "--kv-page-size", "8", "--prefill-chunk", "8"],
    ["--arch", "phi3-medium-14b", "--no-compress"],
    ["--arch", "minitron-8b", "--prefill-chunk", "3"],
    ["--arch", "minitron-8b", "--attn-backend", "{paged}", "--kv-page-size",
     "16", "--prefill-chunk", "16", "--prefix-share", "--shared-prefix-len",
     "32", "--speculate", "ngram", "--prompt-pattern", "8"],
    ["--kv-page-size", "8", "--prefill-chunk", "4", "--prefix-share",
     "--shared-prefix-len", "100", "--requests", "6"],
    ["--arch", "deepseek-v2-236b", "--speculate", "draft", "--draft-k", "7",
     "--prompt-pattern", "5", "--prompt-len", "23"],
    ["--speculate", "ngram", "--draft-k", "2", "--kv-page-size", "4",
     "--kv-codec", "cluster", "--shared-prefix-len", "10"],
]

# what ``--cache-mb auto`` is told by the recorders' autotuner
RECOMMENDED = dict(capacity=3 * 2 ** 20, fraction=0.75, hit_rate=0.8,
                   best_rate=0.85, working_set=4 * 2 ** 20,
                   capacities=[3 * 2 ** 20], rates=[0.8])


class _Stop(Exception):
    pass


def _recorders(seen):
    class Engine:
        """Records the engine settings; stands in for a compressed engine
        (a store, a cache, a report) when ``--cache-mb auto`` needs one."""

        def __init__(self, cfg, params, **kw):
            seen["cfg"] = dataclasses.asdict(cfg)
            seen["compress"] = kw["compress"]
            tel = kw.get("telemetry")
            seen["engine"] = (kw["cache_bytes"], kw["cache_policy"],
                              None if tel is None else tel.tracing)
            self.compressed = "recommend" in seen
            self.cache = types.SimpleNamespace(
                capacity_bytes=kw["cache_bytes"])
            self.store, self.model_id = "store", "lm"
            self.report = dict(layers=1, packed_bytes=2, stream_bytes=2,
                               ratio_stream=1.0)

    class Sched:
        """Records the settings and the submitted prompts; stops at run."""

        def __init__(self, engine, **kw):
            seen["sched"] = kw
            seen["prompts"] = []
            seen["capacity"] = engine.cache.capacity_bytes

        def submit(self, prompt, gen):
            seen["prompts"].append((np.asarray(prompt).tolist(), gen))

        def run(self):
            raise _Stop

    def recommend(store, model_id, **kw):
        seen["recommend"] = (store, model_id, kw)
        return RECOMMENDED

    return Engine, Sched, recommend


def reference_settings(argv, monkeypatch, scheduler=None):
    seen = {"recommend": None} if "auto" in argv else {}
    engine, sched, recommend = _recorders(seen)
    monkeypatch.setattr(jax_launch, "recommend_store_capacity", recommend)
    monkeypatch.setattr(jax_launch, "ServeEngine", engine)
    monkeypatch.setattr(jax_launch, "Scheduler", scheduler or sched)
    monkeypatch.setattr(jax_launch, "get_model", lambda cfg: types.
                        SimpleNamespace(init_params=lambda cfg, key: {}))
    argv = [a.format(paged="pallas_paged") for a in argv]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(_Stop):
        jax_launch.main()
    seen["sched"]["attn_backend"] = seen["sched"]["attn_backend"].replace(
        "pallas_paged", "cuda_paged")
    return seen


def port_settings(argv, monkeypatch, scheduler=None):
    seen = {"recommend": None} if "auto" in argv else {}
    engine, sched, recommend = _recorders(seen)
    monkeypatch.setattr(serve_launch, "recommend_store_capacity", recommend)
    monkeypatch.setattr(serve_launch, "ServeEngine", engine)
    monkeypatch.setattr(serve_launch, "Scheduler", scheduler or sched)
    monkeypatch.setattr(serve_launch, "init_params",
                        lambda cfg, gen, device: {})
    argv = [a.format(paged="cuda_paged") for a in argv]
    with pytest.raises(_Stop):
        serve_launch.main([*argv, "--device", "cpu"])
    return seen


def check_same_settings(argv, monkeypatch):
    """Both launchers on ``argv``: the same config, engine settings,
    capacity, scheduler settings and prompts."""
    want = reference_settings(argv, monkeypatch)
    got = port_settings(argv, monkeypatch)
    assert got["cfg"] == want["cfg"]
    assert got["compress"] == want["compress"]
    assert (got["engine"], got["capacity"], got.get("recommend")) == \
        (want["engine"], want["capacity"], want.get("recommend"))
    if "auto" in argv:
        assert got["capacity"] == RECOMMENDED["capacity"]
        assert got["recommend"] == ("store", "lm", {"policy": "freq"})
    tracing = {"--trace-out", "--trace-jsonl"} & set(argv)
    assert got["engine"][2] == (bool(tracing) if tracing or
                                "--metrics-out" in argv else None)
    assert {k: got["sched"][k] for k in SETTINGS} == \
        {k: want["sched"][k] for k in SETTINGS}
    assert got["prompts"] == want["prompts"] and got["prompts"]
    assert want["sched"]["kernel_tune"] is None
    assert (want["sched"]["prefix_share"], want["sched"]["speculate"],
            want["sched"]["draft_k"]) == \
        ("--prefix-share" in argv,
         argv[argv.index("--speculate") + 1] if "--speculate" in argv
         else "off",
         int(argv[argv.index("--draft-k") + 1]) if "--draft-k" in argv
         else 4)
    if not argv:
        assert (got["cfg"]["name"], got["sched"]["attn_backend"],
                got["sched"]["prefill_chunk"],
                got["sched"]["kv_page_size"]) == \
            ("gemma2-2b", "gathered", None, None)


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_same_argv_builds_the_same_scheduler(argv, monkeypatch):
    check_same_settings(argv, monkeypatch)


@pytest.mark.parametrize("chunk", [[], ["--prefill-chunk", "16"]])
def test_kernel_backend_without_a_page_size_raises(chunk, monkeypatch):
    """The real schedulers: each launcher's kernel backend with no
    ``--kv-page-size`` raises before the scheduler touches the engine."""
    argv = ["--attn-backend", "{paged}", *chunk]

    def real(scheduler):
        def build(engine, **kw):
            scheduler(engine, **kw)
            raise _Stop
        return build

    with pytest.raises(ValueError, match="kv_page_size"):
        reference_settings(argv, monkeypatch, real(JaxScheduler))
    with pytest.raises(ValueError, match="kv_page_size"):
        port_settings(argv, monkeypatch, real(Scheduler))


def test_kernel_tune_alone_is_still_refused():
    """The autotuner is not ported: the port's scheduler refuses
    ``kernel_tune`` with ``NotImplementedError`` on any backend, while
    prefix sharing and speculation are accepted."""
    cfg = serve_launch.tiny_config("minitron-8b")
    engine = ServeEngine(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), device="cpu",
        compress=False)
    for tune in ("auto", "16", "16,1"):
        for backend in ("gathered", "cuda_paged"):
            with pytest.raises(NotImplementedError, match="kernel_tune"):
                Scheduler(engine, kernel_tune=tune, attn_backend=backend,
                          kv_page_size=16)
    sched = Scheduler(engine, kv_page_size=16, prefill_chunk=16,
                      prefix_share=True, speculate="ngram", draft_k=2)
    assert (sched.prefix_share, sched.speculate, sched.draft_k) == \
        (True, "ngram", 2)
    assert Scheduler(engine, kernel_tune="off", kv_page_size=16).drafter \
        is None
