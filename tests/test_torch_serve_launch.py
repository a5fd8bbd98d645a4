"""The port's serve launcher reads argv as the reference's does, on the CPU.

The same argv lists go through ``repro.launch.serve.main`` and
``repro_torch.launch.serve.main`` (plus ``--device cpu``, a flag of the
port only) with the engine and the scheduler replaced by recorders: both
must build the same model config and hand the scheduler the same
settings, the backend ``pallas_paged`` read as ``cuda_paged``.  Omitted
flags mean the reference's defaults: gemma2-2b, the ``gathered`` backend,
monolithic prefill and monolithic lanes.  ``cuda_paged`` without a page
size raises, as the reference's ``pallas_paged`` does.
"""

import dataclasses
import sys
import types

import pytest

import repro.launch.serve as jax_launch
from repro.runtime import Scheduler as JaxScheduler
from repro_torch.launch import serve as serve_launch
from repro_torch.runtime import Scheduler

# the settings both launchers hand the scheduler
SETTINGS = ("batch_size", "mode", "prefill_chunk", "prefill_budget",
            "kv_page_size", "kv_pages", "attn_backend", "kv_codec",
            "log_every")

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
]


class _Stop(Exception):
    pass


def _recorders(seen):
    class Engine:
        def __init__(self, cfg, params, **kw):
            seen["cfg"] = dataclasses.asdict(cfg)
            seen["compress"] = kw["compress"]
            self.compressed = False

    def sched(engine, **kw):
        seen["sched"] = kw
        raise _Stop

    return Engine, sched


def reference_settings(argv, monkeypatch, scheduler=None):
    seen = {}
    engine, sched = _recorders(seen)
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
    seen = {}
    engine, sched = _recorders(seen)
    monkeypatch.setattr(serve_launch, "ServeEngine", engine)
    monkeypatch.setattr(serve_launch, "Scheduler", scheduler or sched)
    monkeypatch.setattr(serve_launch, "init_params",
                        lambda cfg, gen, device: {})
    argv = [a.format(paged="cuda_paged") for a in argv]
    with pytest.raises(_Stop):
        serve_launch.main([*argv, "--device", "cpu"])
    return seen


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_same_argv_builds_the_same_scheduler(argv, monkeypatch):
    want = reference_settings(argv, monkeypatch)
    got = port_settings(argv, monkeypatch)
    assert got["cfg"] == want["cfg"]
    assert got["compress"] == want["compress"]
    assert {k: got["sched"][k] for k in SETTINGS} == \
        {k: want["sched"][k] for k in SETTINGS}
    assert (want["sched"]["prefix_share"], want["sched"]["kernel_tune"],
            want["sched"]["speculate"]) == (False, None, "off")
    if not argv:
        assert (got["cfg"]["name"], got["sched"]["attn_backend"],
                got["sched"]["prefill_chunk"],
                got["sched"]["kv_page_size"]) == \
            ("gemma2-2b", "gathered", None, None)


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
