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
from tests.test_torch_serve_launch import check_same_settings

FLAG_ARGVS = [
    ["--trace-out", "trace.json", "--attn-backend", "{paged}",
     "--kv-page-size", "16"],
    ["--trace-jsonl", "trace.jsonl", "--kv-page-size", "8"],
    ["--metrics-out", "metrics.prom", "--prefill-chunk", "4", "--cache-mb",
     "0.5"],
    ["--cache-mb", "auto", "--arch", "minitron-8b", "--policy", "freq"],
]


@pytest.mark.parametrize("argv", FLAG_ARGVS, ids=" ".join)
def test_same_argv_builds_the_same_scheduler(argv, monkeypatch):
    check_same_settings(argv, monkeypatch)


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
