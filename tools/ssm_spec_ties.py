"""Greedy tokens of mamba2 with and without n-gram speculation, on the CPU.

Serves four requests whose prompts repeat an 8-token pattern (so the
n-gram drafter proposes drafts) through the port's scheduler, plain and
speculative, at a mamba2 config of the given dtype, depth and width (the
tiny config's SSM otherwise).  Where the tokens first differ, prints the
top three logits of the scoring forward over the plain run's prefix, in
the run's dtype and in float32: an exact or near tie in the run's dtype,
with float32 agreeing with one side, is rounding (the verify block's
chunked scan and the one-token update round differently), not a fault.

    PYTHONPATH=src python tools/ssm_spec_ties.py bfloat16 16 512
    PYTHONPATH=src python tools/ssm_spec_ties.py float32 16 512
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.launch.serve import init_params
from repro_torch.launch.train import tiny_config
from repro_torch.models.api import get_model
from repro_torch.runtime import Scheduler, ServeEngine, ServeMetrics
from repro_torch.tree import tree_map


def main(dtype: str, layers: int, width: int) -> None:
    torch.set_num_threads(4)
    cfg = tiny_config("mamba2-780m").scaled(
        dtype=dtype, num_layers=layers, scan_repeats=layers, d_model=width)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engine = ServeEngine(cfg, params, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, 8), 6)[:n]
               for n in (32, 40, 48, 24)]

    def serve(**kw):
        engine.metrics = ServeMetrics()
        sched = Scheduler(engine, batch_size=4, prefill_chunk=16,
                          kv_page_size=16, attn_backend="gathered", **kw)
        for p in prompts:
            sched.submit(p, 24)
        return {r.rid: tuple(r.generated) for r in sched.run()}

    plain = serve()
    spec = serve(speculate="ngram", draft_k=4)
    m = engine.metrics
    print(f"{dtype}, {layers} layers, d_model {width}: "
          f"{'identical' if plain == spec else 'DIFFERENT'} tokens; "
          f"{m.spec_accepted_tokens}/{m.spec_draft_tokens} drafts accepted")
    api = get_model(cfg)
    f32 = cfg.scaled(dtype="float32")
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                   params)
    for rid in plain:
        if plain[rid] == spec[rid]:
            continue
        i = next(i for i, (a, b) in enumerate(zip(plain[rid], spec[rid]))
                 if a != b)
        seq = np.concatenate([prompts[rid], np.array(plain[rid][:i])])
        tokens = torch.from_numpy(seq[None].astype(np.int64))
        print(f"request {rid}: first difference at token {i}: plain "
              f"{plain[rid][i]}, speculative {spec[rid][i]}")
        for c, p in ((cfg, params), (f32, p32)):
            with torch.no_grad():
                logits = api.forward(c, p, tokens)[0][0, -1].float()
            top = torch.topk(logits, 3)
            print(f"  {c.dtype} top 3 {top.indices.tolist()} "
                  f"{[round(v, 4) for v in top.values.tolist()]}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
