"""The ``fit`` kind: whole fits back to back on fixed points, the targets
made in set-up and cycled in an order drawn from the seed; the last fit
of each of the first ``checked_targets`` of that order is judged."""
from torch.profiler import record_function

from port_bench import generate
from port_bench import reference as ref
from port_bench.workloads import Traffic, sync, telemetry


class Runner(Traffic):
    """Whole fits back to back on fixed points, the targets cycled."""

    def setup(self):
        x, ys = self.inputs.x, self.inputs.targets
        # the targets are cycled in an order drawn from the seed; the first
        # ``checked_targets`` of it are judged (the last fit of each), so
        # any window of that many fits has them
        rng = generate.host_rng(self.seed, "sample")
        self.order = rng.permutation(ys.shape[0]).tolist()
        self.kept_targets = self.order[:self.traffic["checked_targets"]]
        self.kept = {}
        self.program.fit(x, ys[self.order[-1]])   # builds, warms the kernels
        sync(self.device)

    def window(self, seconds: float) -> dict:
        x, ys = self.inputs.x, self.inputs.targets
        t0 = sync(self.device)
        done = 0
        while True:
            with record_function("bench.cycle"):
                j = self.order[done % len(self.order)]
                y = ys[j]
            with record_function("bench.fit"):
                model = self._attempt(self.program.fit, x, y)
                t1 = sync(self.device)
            done += 1
            if model is not None:
                self.fits.append(telemetry(model))
                if j in self.kept_targets:
                    self.kept[j] = (model.beta, model.tables)
            del model
            if t1 - t0 >= seconds and done >= len(self.kept_targets):
                break
        return {"fit_s": (t1 - t0) / done, "window_s": t1 - t0}

    def release(self):
        self.program = None

    def check(self, limits: dict) -> dict:
        cfg, x = self.cfg, self.inputs.x
        lsh = generate.reference_lsh(self.inputs.lsh, self.device)
        feats = ref.features(x, lsh, cfg["bucket"], cfg["table_size"])
        beta_err = tables_err = 0.0
        for j in self.kept_targets:
            if j not in self.kept:
                return {"fits_checked": {"value": 0, "limit": len(
                    self.kept_targets)}}
            beta_p, tables_p = self.kept[j]
            beta_r, _, _ = ref.fit(x, self.inputs.targets[j], lsh, cfg,
                                   feats=feats)
            beta_err = max(beta_err, ref.rel_err(beta_p, beta_r))
            # B3 on the program's own beta: the tables it must give
            want = ref.loads(feats[0], feats[1], beta_p.float(),
                             cfg["table_size"])
            tables_err = max(tables_err, ref.rel_err(tables_p, want))
            del want, beta_r
        return {"beta_err": {"value": beta_err, "limit": limits["beta_err"]},
                "tables_err": {"value": tables_err,
                               "limit": limits["tables_err"]}}
