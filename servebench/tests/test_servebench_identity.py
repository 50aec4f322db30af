"""What the ``lm`` configurations read, held to values recorded before the
architecture-dependent parts moved into the configuration's module.

The weights, the float32 reference's logits and the float8 control's, on
the tiny configurations of ``test_servebench_reference``; the operation
counts and flash bounds of both real configuration files. Each is taken
through the module as the harness loads it (``harness.load_reference``),
and has to equal, bit for bit, what ``servebench.weights``,
``servebench.reference.lm`` and ``servebench.roofline`` gave when each
held its part for the one ``lm`` architecture. A change to any of them
that moves a reading of the existing cells fails here.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch

from servebench import harness, roofline
from servebench import weights as W
from servebench.tests.test_servebench_reference import DENSE, MOE

BENCH = Path(__file__).resolve().parents[1]
SEED = 2**33 + 5
CONFIGS = {"dense": DENSE, "moe": MOE, "moe_bf16": dict(MOE, compute_dtype="bfloat16")}
PROMPTS = [list(range(3, 27)), [5, 9, 2, 60, 61]]
SERVED = [[7, 1, 9, 2], [33, 4, 4, 18, 2, 50]]

#: The shared leaves of the three tiny configurations (one seed, one path, one layer).
_SHARED = {
    "embed.table": "4be29632d5313eca",
    "final_norm.scale": "b638277a8690e175",
    "blocks.pos0.mixer_norm.scale": "2f20cd03c9cd392a",
    "blocks.pos0.ffn_norm.scale": "2f20cd03c9cd392a",
}
_F32_ATTN = {
    "blocks.pos0.attn.wq": "9c7c7ef0476284cf",
    "blocks.pos0.attn.wk": "a9050d3d6666cebc",
    "blocks.pos0.attn.wv": "3f4d543ae99d11d0",
    "blocks.pos0.attn.wo": "ea154763a13a5846",
}
_LAYERNORM = {
    "final_norm.bias": "38723a2e5e8a17aa",
    "lm_head.table": "f956b18c53256274",
    "blocks.pos0.mixer_norm.bias": "5341e6b2646979a7",
    "blocks.pos0.ffn_norm.bias": "5341e6b2646979a7",
    "blocks.pos0.moe.router": "4b5b0e96f06d620b",
}
#: sha256 (first 16 hex digits) of each leaf's bytes, bf16 leaves as int16.
WEIGHTS = {
    "dense": {**_SHARED, **_F32_ATTN,
              "blocks.pos0.ffn.w_gate": "4b03264b480eee46",
              "blocks.pos0.ffn.w_up": "f29ab0a32835619f",
              "blocks.pos0.ffn.w_down": "d60b4c5015980aa6"},
    "moe": {**_SHARED, **_F32_ATTN, **_LAYERNORM,
            "blocks.pos0.moe.w_gate": "de5773d0a2a792eb",
            "blocks.pos0.moe.w_up": "1ff42ac5f64a522f",
            "blocks.pos0.moe.w_down": "62a68629f172c426"},
    "moe_bf16": {**_SHARED, **_LAYERNORM,
                 "blocks.pos0.attn.wq": "52a944777e8ba05c",
                 "blocks.pos0.attn.wk": "8cd0ef7eb0c9f3bc",
                 "blocks.pos0.attn.wv": "66bfa62d7aebfc42",
                 "blocks.pos0.attn.wo": "bad5e88ff026f27b",
                 "blocks.pos0.moe.w_gate": "e9d01b6c93e1ce40",
                 "blocks.pos0.moe.w_up": "cd3442d2eb1c71c5",
                 "blocks.pos0.moe.w_down": "2a52841ec25b1530"},
}
#: The same of each prompt's logits [len(served), V].
LOGITS = {
    ("dense", None): ["f7939fd37a0738d5", "7acf13eda7318d28"],
    ("dense", "fp8"): ["b00666960f821b63", "5bd3b6e51cd02849"],
    ("moe", None): ["8bb6d15c4f6bb08e", "da86e0a60481d1ac"],
    ("moe", "fp8"): ["8a8f71b5803cfc98", "ef83eadc28e9cc23"],
}
#: decode_token_flops at positions 0, 511, 1023; prefill_flops at S = 32, 192,
#: 960; flash_bound_s at those S; and a prefill's flash bound (all its layers).
COUNTS = {
    "smollm-135m": {
        "decode": [269028864, 304349184, 339738624],
        "prefill": [6887890944, 42105913344, 235783471104],
        "flash": [2.9344477611940297e-08, 1.760668656716418e-07, 1.0746098281092013e-06],
        "flash_prefill": [8.803343283582089e-07, 5.282005970149254e-06,
                          3.223829484327604e-05],
    },
    "phi3.5-moe-8l": {
        "decode": [3451518976, 3518496768, 3585605632],
        "prefill": [102370902016, 614925336576, 3121894391808],
        "flash": [1.9562985074626866e-07, 1.173779104477612e-06, 7.641669888776542e-06],
        "flash_prefill": [1.5650388059701493e-06, 9.390232835820895e-06,
                          6.113335911021234e-05],
    },
}


def _sha(t: torch.Tensor) -> str:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


@pytest.fixture(scope="module")
def lm():
    return harness.load_reference(BENCH, {"reference": "lm"}, "lm configurations")


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_weights_as_recorded(lm, name):
    params = W.make_params(lm, CONFIGS[name], SEED, "cpu")
    assert {k: _sha(v) for k, v in W.iter_leaves(params)} == WEIGHTS[name]


@pytest.mark.parametrize("name,quant", sorted(LOGITS, key=str),
                         ids=[f"{n}-{q or 'f32'}" for n, q in sorted(LOGITS, key=str)])
def test_reference_logits_as_recorded(lm, name, quant):
    logits = lm.teacher_forced_logits(CONFIGS[name], SEED, PROMPTS, SERVED, "cpu", quant=quant)
    assert [_sha(x) for x in logits] == LOGITS[(name, quant)]


@pytest.mark.parametrize("conf", sorted(COUNTS))
def test_counts_as_recorded(conf):
    config = json.loads((BENCH / "configs" / f"{conf}.json").read_text())
    module = harness.load_reference(BENCH, config, conf)
    cfg, sizes = config["model"], (32, 192, 960)
    got = {
        "decode": [module.decode_token_flops(cfg, p) for p in (0, 511, 1023)],
        "prefill": [module.prefill_flops(cfg, s) for s in sizes],
        "flash": [roofline.flash_bound_s(cfg, s) for s in sizes],
        "flash_prefill": [module.attention_layers(cfg) * roofline.flash_bound_s(cfg, s)
                          for s in sizes],
    }
    assert got == COUNTS[conf]
