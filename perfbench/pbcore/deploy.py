"""One configuration as a deployment: its data, its calls into the port, and
its references, all read from ``configs/<config>.json``.

The file names the public calls and their keyword arguments, so a new
configuration of the same calls is a new file:

- ``pattern``: the npz of the fixed users x items pattern;
- ``values``: the values kind that fills it by the seed
  (``values/<kind>.py``);
- ``weighting``: a ``similaripy_tpu_torch.normalization`` function the port
  applies to the ratings in set-up, or null;
- ``build``: the model build, ``{"function", "kwargs"}``, called as
  ``function(ratings.T, **kwargs)`` (item-item, over the item vectors);
- ``model`` and ``score``: the item-item model the seed draws (its model
  kind, ``models/<kind>.py``), and the scoring call
  ``function(weighted, model.T, **kwargs, filter_cols=ratings)``;
- ``reference``: the module under ``reference/`` of each call, with the
  precision of its control. A reference gets the call's whole keyword
  arguments and the configuration, and refuses what it does not compute.
"""

from __future__ import annotations

import numpy as np

from . import data, manifest


class Deployment:
    def __init__(self, name: str, device, seed: int, scale: dict | None = None,
                 bench_dir=manifest.BENCH_DIR):
        self.name = name
        self.bench_dir = bench_dir
        self.cfg = manifest.config(name, bench_dir)
        self.device = device
        self.seed = seed
        scale = scale or {}
        self.pattern = data.load_pattern(self.cfg["pattern"], scale.get("users"),
                                         scale.get("items"))
        self._values = None

    # ---- data ---------------------------------------------------------
    def values(self, version: int) -> np.ndarray:
        """Version `version` of the ratings' values (the first call draws
        them)."""
        if self._values is None:
            kind = manifest.part("values", self.cfg["values"], self.bench_dir)
            self._values = kind.Values(self.seed, self.pattern.nnz, self.device)
        return self._values(version)

    def ratings(self, values: np.ndarray):
        return self.pattern.csr(values)

    def model(self):
        m = self.cfg["model"]
        kind = manifest.part("models", m["kind"], self.bench_dir)
        return kind.draw(self.seed, self.pattern.item_counts(), m, self.device)

    # ---- the port's calls ---------------------------------------------
    @staticmethod
    def _sim():
        import similaripy_tpu_torch as sim

        return sim

    def weighted(self, ratings):
        w = self.cfg.get("weighting")
        if not w:
            return ratings
        fn = getattr(self._sim().normalization, w["function"])
        return fn(ratings, **w.get("kwargs", {}), device=self.device)

    def build(self, ratings, targets=None):
        b = self.cfg["build"]
        fn = getattr(self._sim(), b["function"])
        return fn(ratings.T, **b["kwargs"], target_rows=targets, verbose=False,
                  device=self.device)

    def score(self, weighted, model_t, ratings, users):
        s = self.cfg["score"]
        fn = getattr(self._sim(), s["function"])
        filt = ratings if s.get("filter_seen") else None
        return fn(weighted, model_t, **s["kwargs"], target_rows=users, filter_cols=filt,
                  verbose=False, device=self.device)

    # ---- references -----------------------------------------------------
    def _reference(self, call: str):
        """(module, control precision) of `call` ('build' or 'score')."""
        ref = self.cfg["reference"][call]
        return manifest.reference(ref["module"], self.bench_dir), ref["control"]

    def build_reference(self):
        module, control = self._reference("build")
        return module.Reference(self.pattern, self.cfg["build"], self.cfg, self.device), control

    def score_reference(self, values: np.ndarray, model):
        module, control = self._reference("score")
        return module.Reference(self.pattern, values, model, self.cfg["score"], self.cfg,
                                self.device), control
