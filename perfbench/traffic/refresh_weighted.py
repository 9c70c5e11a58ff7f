"""Traffic kind ``refresh_weighted``: ``refresh`` on weighted ratings.

As ``refresh`` (``traffic/refresh.py``, whose batch draw and check it
takes whole): every call recomputes the neighbour rows of the items a
batch of new ratings changed, on ratings that stay fixed. Set-up applies
the configuration's ``weighting`` to the ratings once, on the port, and
every call, the warm-up included, passes that same weighted matrix with
its batch as ``target_rows``. The check hands the reference the raw
ratings, from which it works the weights out again. Parameters:
``targets``, ``check_rows``.
"""

from __future__ import annotations

from pathlib import Path

from pbcore import manifest

refresh = manifest.load_file(Path(__file__).with_name("refresh.py"), "pb_traffic_refresh")


class Traffic(refresh.Traffic):
    def setup(self):
        self.values = self.dep.values(0)
        self.ratings = self.dep.weighted(self.dep.ratings(self.values))
        self.dep.build(self.ratings, self.batch(refresh.WARM_UP))
