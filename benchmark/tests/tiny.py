"""A checkout in a temporary directory with a tiny eval cell beside the
real ones, for the CPU tests: the real benchmark folder and
BENCHMARK.json, a tiny configuration, a tiny traffic mix and its limits,
added as new files and entries only."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny", "source": "test", "reduced": [],
    "resnet_name": "resnet18", "image_size": [64, 48], "num_views": 3,
    "fpn_channels": 8, "tokenizer_out_channels": 32,
    "ray_points_scale": [-3.0, 3.0, -2.0, 0.5, 0.25, 5.25],
    "num_samples": 8, "min_depth": 0.25, "max_depth": 5.25,
    "dec_dim": 32, "dec_heads": 4, "dec_ffn_dim": 16, "dec_layers": 2,
    "num_queries": 112, "num_semcls": 9,
    "scale": [-3.0, 3.0, -2.0, 0.5, 0.25, 5.25],
    "class_names": ["chair", "table", "cabinet", "trash bin", "bookshelf",
                    "display", "sofa", "bathtub", "other"],
    "mean_size_path": "data/average_scan2cad.txt",
    "compute_dtype": "float32", "dropout_rate": 0.1, "remat": False,
    "lr": 1e-4, "weight_decay": 0.01, "max_norm": 1.0,
    "loss_weight": [5.0, 5.0, 5.0, 1.0],
    "track_scale": [-1.5, 1.5, -2.0, 1.0, 0.0, 2.0], "conf_thresh": 0.0,
    "enable_nms": True,
}

TRAFFIC = {"loop": "eval", "batch": 2, "pool_batches": 2, "boxes": [1, 4],
           "trace_from": 0.0, "trace_batches": 2, "check_batches": 2}
LIMITS = {"output_gap": 1e-4, "parse_mismatch": 0}


def make_root(tmp: Path, extra_config: dict = None) -> Path:
    """`tmp` as a checkout: the benchmark, the mean-size table, and the
    tiny cell `tiny-eval` added."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp / "data").mkdir()
    shutil.copy(REPO / "data" / "average_scan2cad.txt", tmp / "data")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = dict(TINY, **(extra_config or {}))
    (tmp / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "CPU test"})
    (tmp / "benchmark" / "traffic" / "tiny-eval.json").write_text(
        json.dumps(TRAFFIC))
    (tmp / "benchmark" / "limits" / "tiny-eval.json").write_text(
        json.dumps(LIMITS))
    bench["workloads"].append({"name": "tiny-eval", "config": "tiny",
                               "traffic": "tiny-eval", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny-eval")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
