"""Fixtures of the benchmark's CPU tests: a checkout-like root with the
benchmark's files, to which a test adds a configuration, a traffic file
and manifest entries of its own, at a size the CPU runs in seconds."""
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# a StarCoder2-like and a DeepSeek-V2-like model at a size the CPU holds,
# in bf16 as the cells serve them
TINY_GQA = {
    "model_type": "starcoder2", "hidden_act": "gelu_pytorch_tanh",
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 256, "rope_theta": 1000000, "norm_type": "layer_norm",
    "torch_dtype": "bfloat16", "port_arch": "starcoder2_7b",
    "reduced": [], "assumed": {}}
TINY_MLA = {
    "model_type": "deepseek_v2", "hidden_act": "silu", "hidden_size": 64,
    "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 4, "vocab_size": 256,
    "rope_theta": 10000, "q_lora_rank": 48, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "n_routed_experts": 8, "n_shared_experts": 1, "num_experts_per_tok": 2,
    "moe_intermediate_size": 32, "torch_dtype": "bfloat16",
    "port_arch": "deepseek_v2_236b", "reduced": [],
    "assumed": {"moe_capacity_factor": 1.25, "moe_in_every_layer": True}}
# At this size the bf16 programs read 0.005-0.01 and the fp8 control
# 0.06-0.095 (worst row, four seeds): limits between, as the cells' are
# set; the MLA model's, as DeepSeek-V2's, on the median row alone
TINY_LIMITS = {"gqa": {"logits_err_median": 0.03, "logits_err_max": 0.03},
               "mla": {"logits_err_median": 0.03}}
TINY_TRAFFIC = {"kind": "prefill", "batch": 2, "prompt_len": 128, "gen": 4,
                "pool": 3, "agent": "ppo", "agent_seed": 0,
                "fit_steps": 64, "warmup": 1, "trace_prefills": 2}


def make_root(tmp: Path, configs: dict, traffic: dict, cells: list) -> Path:
    """A root holding ``BENCHMARK.json`` and the benchmark's files, plus
    the configurations ``configs`` (name -> file contents), the traffic
    files ``traffic`` (name -> contents) and the cells ``cells``
    ((name, config, traffic)), each added to every metric that lists
    cells."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in configs.items():
        f = f"perfbench/configs/{name}.json"
        (root / f).write_text(json.dumps(cfg))
        m["configs"].append({"name": name, "source": "a test",
                             "file": f, "reduced": [], "why": "a test"})
    for name, tr in traffic.items():
        (root / "perfbench" / "workloads" / f"{name}.json").write_text(
            json.dumps(tr))
    for name, cfg, tr in cells:
        m["workloads"].append({"name": name, "config": cfg, "traffic": tr,
                               "chips": 1, "why": "a test"})
        for metric in m["per_layer"] + m["end_to_end"]:
            if "workloads" in metric:
                metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    """A root with the tiny GQA and MLA models under the tiny traffic."""
    cfgs = {"tiny_gqa": dict(TINY_GQA, limits=TINY_LIMITS["gqa"]),
            "tiny_mla": dict(TINY_MLA, limits=TINY_LIMITS["mla"])}
    return make_root(tmp_path, cfgs, {"tiny": TINY_TRAFFIC},
                     [("tiny_gqa.tiny", "tiny_gqa", "tiny"),
                      ("tiny_mla.tiny", "tiny_mla", "tiny")])

