"""A benchmark tree at smoke sizes, for the CPU tests: a copy of the
benchmark's folder with tiny configurations, mixes and cells beside the real
ones, and a ``BENCHMARK.json`` that names them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from agentbench.spec import PACKAGE, ROOT

TINY = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
        "vocab_size": 256, "max_position_embeddings": 2048,
        "engine": {"block_size": 16, "max_batch": 4, "token_budget": 32,
                   "prefill_chunk": 32, "max_len": 2048, "num_blocks": 600}}

FLEET = {"arrivals": {"process": "poisson", "sessions_per_s": 3.0},
         "turns_per_session": [2, 3],
         "first_prompt": {"shared_prefix_tokens": 32, "tokens": [8, 24]},
         "later_prompt": {"dist": "pareto", "alpha": 1.2, "min": 4,
                          "max": 40},
         "think_s": [0.05, 0.2], "max_new_tokens": 4, "new_tokens_jitter": 4,
         "prompt_tokens": 64, "preroll_s": 0.3, "setup_turns": 0}

DECODE = {"arrivals": {"process": "at_start", "sessions": 4},
          "turns_per_session": [50, 50],
          "first_prompt": {"shared_prefix_tokens": 0, "tokens": [60, 90]},
          "later_prompt": {"dist": "uniform", "min": 3, "max": 7},
          "think_s": [0.0, 0.0], "max_new_tokens": 6,
          "new_tokens_jitter": 4, "prompt_tokens": 90, "preroll_s": 0.0,
          "setup_turns": 1}

# a window far shorter than the decode sessions grow: the client has to stop
# each session before its tokens pass it
WINDOW = 160

LIMITS = {"turns_lost": 0, "delivery_mismatches": 0, "history_mismatches": 0,
          "kv_tokens_unwritten": 0, "kv_rel_err": 0.025, "logit_gap": 0.06}


def _dump(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_tree(dest: Path) -> Path:
    """``dest`` holding the benchmark's folder and BENCHMARK.json, plus
    ``tiny-sc2`` / ``tiny-glm3`` configurations (the two models' code paths
    at smoke widths), ``tiny-sc2-window`` (``tiny-sc2`` with a sliding
    window of ``WINDOW``), ``tiny-glm3-two-groups`` (``tiny-glm3`` of the
    kind ``two_groups``, ``kind_two_groups.py`` copied into ``kinds/``)
    and the cells ``tiny-sc2-fleet``, ``tiny-glm3-fleet``,
    ``tiny-sc2-decode``, ``tiny-glm3-decode``, ``tiny-sc2-window-decode``,
    ``tiny-glm3-two-groups-decode``."""
    shutil.copytree(PACKAGE, dest / "agentbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    folder = dest / "agentbench"
    shutil.copy(PACKAGE / "tests" / "kind_two_groups.py",
                folder / "kinds" / "two_groups.py")
    for name, real, over in (("tiny-sc2", "starcoder2-7b", {}),
                             ("tiny-glm3", "chatglm3-6b", {}),
                             ("tiny-sc2-window", "starcoder2-7b",
                              {"sliding_window": WINDOW}),
                             ("tiny-glm3-two-groups", "chatglm3-6b",
                              {"kind": "two_groups"})):
        conf = json.loads((folder / "configs" / f"{real}.json").read_text())
        engine = dict(conf["engine"], **TINY["engine"])
        conf.update(TINY, name=name, engine=engine, **over)
        _dump(folder / "configs" / f"{name}.json", conf)
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"agentbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    _dump(folder / "traffic" / "tiny-fleet.json", FLEET)
    _dump(folder / "traffic" / "tiny-decode.json", DECODE)
    for cell, conf, mix in (("tiny-sc2-fleet", "tiny-sc2", "tiny-fleet"),
                            ("tiny-glm3-fleet", "tiny-glm3", "tiny-fleet"),
                            ("tiny-sc2-decode", "tiny-sc2", "tiny-decode"),
                            ("tiny-glm3-decode", "tiny-glm3", "tiny-decode"),
                            ("tiny-sc2-window-decode", "tiny-sc2-window",
                             "tiny-decode"),
                            ("tiny-glm3-two-groups-decode",
                             "tiny-glm3-two-groups", "tiny-decode")):
        _dump(folder / "cells" / f"{cell}.json",
              {"check": {"sessions": 2, "served_tokens": 20},
               "limits": LIMITS})
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": mix, "chips": 1,
                                   "why": "test"})
        kind = "fleet" if mix == "tiny-fleet" else "decode"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if any(w.endswith(kind) for w in m.get("workloads", ())):
                m["workloads"].append(cell)
    _dump(dest / "BENCHMARK.json", bench)
    return dest
