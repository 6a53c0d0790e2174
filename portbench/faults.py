"""Faults planted underneath a run, to see the check that decides
``correct`` refuse them:

    python -m portbench.faults <fault> --workload <cell> --seed <n> ...

plants ``<fault>`` in the port, then runs ``portbench.run`` with the
remaining arguments. Serving: "altered_token" (each tick's token of
every row altered where the engine receives it), "state_unchanged" (no
decode step writes its K/V into the arena). Training: "state_unchanged"
(the optimizer's step leaves the params and moments as they were),
"half_batch" (the loss is the mean over the first half of the rows),
"window_update_skipped" (the updates after the set-up's steps are
skipped: the window's steps leave the state as it was).
"""
from __future__ import annotations

import sys

KINDS = {"serve": ("altered_token", "state_unchanged"),
         "train": ("state_unchanged", "half_batch", "window_update_skipped")}


def plant(fault: str, mix: dict) -> None:
    kind = mix["kind"]
    if fault not in KINDS[kind]:
        raise SystemExit(f"no fault {fault!r} for a {kind} cell")
    if kind == "serve":
        import nos_tpu_torch.models.generate as gen
        from nos_tpu_torch.models.serving import DecodeServer

        if fault == "altered_token":
            orig = DecodeServer._consume_payload

            def consume(self, ent, toks, now):
                for s in ent.slots:
                    toks[s][0] = (toks[s][0] + 1) % self.cfg.vocab
                return orig(self, ent, toks, now)
            DecodeServer._consume_payload = consume
        else:
            gen.scatter_kv_routed = lambda arena, route, values: None
        return
    import nos_tpu_torch.models.transformer as tfm
    from nos_tpu_torch.train.optim import TrainOptimizer

    if fault == "state_unchanged":
        TrainOptimizer.step = lambda self: self.zero_grad()
    elif fault == "window_update_skipped":
        orig_step = TrainOptimizer.step
        warm = mix["warm_steps"]
        calls = []

        def step(self):
            calls.append(1)
            if len(calls) > warm:
                return self.zero_grad()
            return orig_step(self)
        TrainOptimizer.step = step
    else:
        orig_loss = tfm.loss_fn

        def loss_fn(params, cfg, batch, mesh=None):
            half = batch["tokens"].shape[0] // 2
            return orig_loss(params, cfg,
                             {k: v[:half] for k, v in batch.items()}, mesh)
        tfm.loss_fn = loss_fn


def main(argv=None) -> int:
    from portbench import run, spec

    argv = list(sys.argv[1:] if argv is None else argv)
    fault = argv.pop(0)
    args = run.parse(argv)
    bench = spec.load_benchmark()
    plant(fault, spec.load_traffic(
        spec.find_cell(bench, args.workload)["traffic"]))
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
