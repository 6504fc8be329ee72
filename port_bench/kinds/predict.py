"""The ``predict`` kind: bulk scoring.  One model fitted in set-up,
blocks of queries cycled from a pool on the device, each call
synchronized; every ``checked_every``-th call (from an offset drawn from
the seed) is judged, and so is the set-up's fit."""
import math
import time

from torch.profiler import record_function

from port_bench import generate
from port_bench import reference as ref
from port_bench.workloads import Traffic, sync


class Runner(Traffic):
    """Bulk scoring: one model fitted in set-up, blocks of queries cycled
    from a pool on the device, each call synchronized."""

    def setup(self):
        self.model = self.program.fit(self.inputs.x, self.inputs.targets[0])
        q = self.inputs.queries
        self.batch = self.traffic["batch_size"]
        rng = generate.host_rng(self.seed, "sample")
        self.every = int(self.traffic["checked_every"])
        self.offset = int(rng.integers(0, self.every))
        self.kept = []
        self.program.predict(self.model, q[0], self.batch)   # warm
        sync(self.device)

    def window(self, seconds: float) -> dict:
        """Calls back to back; a call's latency is the host clock from its
        start to the return of the synchronize that ends it."""
        q = self.inputs.queries
        rows = q.shape[1]
        lat = []
        t0 = t1 = sync(self.device)
        done = 0
        while True:
            with record_function("bench.cycle"):
                i = done % q.shape[0]
                block = q[i]
            with record_function("bench.predict_call"):
                ts = time.perf_counter()
                out = self._attempt(self.program.predict, self.model, block,
                                    self.batch)
                t1 = sync(self.device)
            lat.append(t1 - ts)
            if out is not None:
                self.rows += rows
                if done % self.every == self.offset:
                    self.kept.append((i, out))
            done += 1
            if t1 - t0 >= seconds and done > self.offset:
                break
        lat.sort()
        return {"predict_rows_per_s": self.rows / (t1 - t0),
                "predict_p95_ms": 1e3 * lat[math.ceil(0.95 * len(lat)) - 1],
                "window_s": t1 - t0}

    def release(self):
        # the model's beta is judged with the calls: the reference reads it
        self.beta = self.model.beta
        self.model = self.program = None

    def check(self, limits: dict) -> dict:
        """The set-up fit's beta against the reference's fit of the same
        inputs (``beta_err``), and each judged call against the
        reference's readout of the tables that the reference builds from
        that beta (``pred_err``): the calls are judged on the model they
        were given, whose fit is judged by itself."""
        cfg, x = self.cfg, self.inputs.x
        if not self.kept:
            return {"calls_checked": {"value": 0, "limit": 1}}
        lsh = generate.reference_lsh(self.inputs.lsh, self.device)
        idx, coeff = ref.features(x, lsh, cfg["bucket"], cfg["table_size"])
        beta_r, _, _ = ref.fit(x, self.inputs.targets[0], lsh, cfg,
                               feats=(idx, coeff))
        beta_err = ref.rel_err(self.beta, beta_r)
        tables = ref.loads(idx, coeff, self.beta.float(), cfg["table_size"])
        del idx, coeff, beta_r
        q = self.inputs.queries
        want = {}
        err = 0.0
        for i, out in self.kept:
            if i not in want:
                want[i] = ref.predict(q[i], lsh, cfg, tables)
            err = max(err, ref.rel_err(out, want[i]))
        return {"beta_err": {"value": beta_err, "limit": limits["beta_err"]},
                "pred_err": {"value": err, "limit": limits["pred_err"]},
                "calls_checked": {"value": len(self.kept), "limit": 1}}
