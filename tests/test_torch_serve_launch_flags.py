"""The port's launcher reads the telemetry and autotune flags as the
reference's does, on the CPU: the argv lists of ``--trace-out``,
``--trace-jsonl``, ``--metrics-out`` and ``--cache-mb`` (a number or
``auto``) through ``test_torch_serve_launch.check_same_settings``, and the
port takes every flag of the reference launcher but ``--kernel-tune``.

These argv lists live here and not in ``test_torch_serve_launch.ARGVS``:
the tier-1 run hands files to its workers largest first, and a
``test_torch_serve_launch.py`` grown past 19 tests would move ahead of
``test_mixed_step.py`` and change which worker runs it (ROADMAP, test
discipline).
"""

import inspect
import re

import pytest

import repro.launch.serve as jax_launch
from repro_torch.launch import serve as serve_launch
from repro_torch.runtime import scheduler as sched_mod
from tests.test_torch_serve_launch import check_same_settings

FLAG_ARGVS = [
    ["--trace-out", "trace.json", "--attn-backend", "{paged}",
     "--kv-page-size", "16"],
    ["--trace-jsonl", "trace.jsonl", "--kv-page-size", "8"],
    ["--metrics-out", "metrics.prom", "--prefill-chunk", "4", "--cache-mb",
     "0.5"],
    ["--cache-mb", "auto", "--arch", "minitron-8b", "--policy", "freq"],
    ["--arch", "mamba2-780m", "--kv-page-size", "4", "--prefill-chunk",
     "3"],
    ["--arch", "recurrentgemma-2b", "--attn-backend", "{paged}",
     "--kv-page-size", "16", "--speculate", "ngram"],
    ["--arch", "paligemma-3b", "--attn-backend", "{paged}",
     "--kv-page-size", "16", "--prefill-chunk", "16"],
    ["--arch", "whisper-large-v3", "--mode", "wave", "--kv-page-size", "8"],
]


@pytest.mark.parametrize("argv", FLAG_ARGVS, ids=" ".join)
def test_same_argv_builds_the_same_scheduler(argv, monkeypatch):
    check_same_settings(argv, monkeypatch)


# each new arch served end to end by the port's launcher at --scale tiny,
# and the downgrade each argv asks for (None: none)
SERVE_ARGVS = [
    (["--arch", "mamba2-780m", "--kv-page-size", "4", "--prefill-chunk",
      "3"], None),
    (["--arch", "recurrentgemma-2b", "--attn-backend", "cuda_paged",
      "--kv-page-size", "16"], "downgraded to the gathered"),
    (["--arch", "paligemma-3b", "--attn-backend", "cuda_paged",
      "--kv-page-size", "16", "--prefill-chunk", "16"],
     "downgraded to monolithic prefill"),
    (["--arch", "whisper-large-v3", "--mode", "wave"], None),
]


@pytest.mark.parametrize("argv,downgrade", SERVE_ARGVS,
                         ids=[" ".join(a) for a, _ in SERVE_ARGVS])
def test_new_archs_serve_through_the_launcher(argv, downgrade, monkeypatch,
                                              capsys):
    monkeypatch.setattr(sched_mod, "_FALLBACK_WARNED", set())
    run = lambda: serve_launch.main(  # noqa: E731
        [*argv, "--device", "cpu", "--gen", "4", "--requests", "3",
         "--batch", "2", "--prompt-len", "12"])
    if downgrade:
        with pytest.warns(RuntimeWarning, match=downgrade):
            done = run()
    else:
        done = run()
    assert [len(r.generated) for r in done] == [4, 4, 4]
    out = capsys.readouterr().out
    assert ("note:" in out) == bool(downgrade)
    compressed = "mamba2" not in argv[1]
    assert ("no compressible MLPs" in out) != compressed


def test_port_takes_every_reference_flag_but_kernel_tune():
    """Diffing the two launchers' ``add_argument`` flags leaves the kernel
    autotuner's ``--kernel-tune`` as the one reference flag the port lacks
    (the port adds ``--device`` and ``--layers``)."""

    def flags(module):
        return set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"',
                              inspect.getsource(module)))

    ref, port = flags(jax_launch), flags(serve_launch)
    assert ref - port == {"--kernel-tune"}
    assert port - ref == {"--device", "--layers"}
