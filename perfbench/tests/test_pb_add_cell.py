"""A cell is added as files only: a new ``workloads/<cell>.json`` and its
``BENCHMARK.json`` entry are found with no change to any code."""

import io
import json
import shutil

from conftest import TINY

from pbcore import driver, manifest


def test_a_new_cell_is_found_by_its_files(tmp_path):
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(manifest.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    wl = json.loads((bench_dir / "workloads" / "ml32m-raw-int8.refresh-8k.json").read_text())
    wl["traffic"] = "refresh-1k"
    wl["params"]["targets"] = 150
    (bench_dir / "workloads" / "ml32m-raw-int8.refresh-1k.json").write_text(json.dumps(wl))
    bench = manifest.benchmark()
    bench["workloads"].append({"name": "ml32m-raw-int8.refresh-1k", "config": "ml32m-raw-int8",
                               "traffic": "refresh-1k", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ml32m-raw-int8.refresh-8k" in m.get("workloads", []):
            m["workloads"].append("ml32m-raw-int8.refresh-1k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    result = driver.run_cell("ml32m-raw-int8.refresh-1k", 5, 0.5, False, device="cpu",
                             scale=TINY, root=tmp_path, bench_dir=bench_dir,
                             out=io.StringIO(), err=io.StringIO()).result
    assert result["correct"]
    assert set(result["metrics"]) == {"refresh_items_per_s", "setup_s"}
    assert result["attempted"] >= 1
