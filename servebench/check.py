"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the window's finished requests, drawn from the seed and holding the one
that served the most tokens, is run through the float32 reference (the
configuration's module, ``servebench/reference/<name>.py``: its
``teacher_forced_logits``) over its prompt and the tokens it was
served. For each served token, its gap is how far the reference's logit of it
lies below the reference's best logit: greedy decoding through the
program's prefill, its slot of the cache and its decode steps, at the
window's sizes, through the flash and gmm kernels and both CUDA graphs,
picks the reference's best token up to the rounding of bf16. The
configuration's ``check`` names the numbers compared and their limits:
the widest gap, or the mean gap where the widest cannot separate a sound
run from the control (``PERF.md`` says why).

The engine's own checks ride beside it: no replica held more requests
than its slots, each finished request got as many tokens as it asked
for, and no request of the window was left unfinished at the drain limit.
So does the router's: each admission of the run obeys the configuration's
``placement``, a transcription of its tAPP script's blocks in the order
they are tried, judged on the loads the router decided on.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def sample(window: List[Dict], seed: int, n: int) -> List[Dict]:
    """Up to ``n`` finished requests of the window: the one with the most
    served tokens, and the rest drawn from the seed. Plain lists, so the
    program's objects can be freed."""
    done = [r for r in window if not r["failed"]]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i]["req"].output))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([int(seed), 3])
    picks = [longest] + list(rng.choice(rest, size=min(n - 1, len(rest)), replace=False))
    return [{"prompt": done[i]["req"].tokens.tolist(), "served": list(done[i]["req"].output)}
            for i in picks]


def engine_checks(window: List[Dict], dep, max_active_over: int) -> Dict:
    max_len = dep.replicas[0].max_len
    short = sum(1 for r in window if not r["failed"]
                and len(r["req"].output) != min(r["max_new_tokens"], max_len - r["prompt_len"]))
    return {
        "slots_over": {"value": max_active_over, "limit": 0},
        "short_outputs": {"value": short, "limit": 0},
        "unfinished": {"value": sum(1 for r in window if r["failed"]), "limit": 0},
    }


def placement_checks(placed: List[tuple], replicas, rules: Dict) -> Dict:
    """How many admissions broke the configuration's ``placement``.

    ``rules["tags"]`` maps a tag ("" for none; a tag it lacks takes "")
    to its blocks in the order the script tries them, each a ``zone``
    (null for any), a ``full_at_pct`` (a replica with that share of its
    slots in use or more is not valid) and, where the block names one, a
    ``controller``. The first block with a valid replica is the one that
    places: the admission has to be on one of that block's valid
    replicas, by its controller. Where no block has one, the script fails
    the request, and an admission breaks it."""
    zones = [rep.zone for rep in replicas]
    slots = [rep.slots for rep in replicas]
    tags = rules["tags"]
    bad = 0
    for tag, k, controller, in_use in placed:
        for block in tags.get(tag or "", tags[""]):
            valid = [j for j, n in enumerate(in_use) if n is not None
                     and block["zone"] in (None, zones[j])
                     and 100.0 * n / slots[j] < block["full_at_pct"]]
            if valid:
                bad += k not in valid or block.get("controller", controller) != controller
                break
        else:
            bad += 1
    return {"placement_violations": {"value": bad, "limit": 0}}


def token_gaps(ref_logits, tokens) -> torch.Tensor:
    """Per position, how far the reference's logit of the token there lies
    below the reference's best logit (0 where it is the best)."""
    out = []
    for logits, toks in zip(ref_logits, tokens):
        idx = torch.as_tensor(list(toks), dtype=torch.long, device=logits.device)
        out.append(logits.max(dim=-1).values - logits.gather(1, idx[:, None])[:, 0])
    return torch.cat(out).double().cpu()


#: The numbers a configuration's ``check`` may compare, from the per-token gaps.
NUMBERS = {
    "max_logit_gap": lambda g: float(g.max()),
    "mean_logit_gap": lambda g: float(g.mean()),
}


def reference_checks(reference, config: Dict, limits: Dict, seed: int, picked: List[Dict],
                     device) -> Dict:
    """Each number ``limits`` names (the cell's ``check``), over the sample's
    served tokens under the configuration's module ``reference``, beside
    its limit."""
    if not picked:
        return {name: {"value": None, "limit": limit} for name, limit in limits.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    served = [p["served"] for p in picked]
    with torch.no_grad():
        logits = reference.teacher_forced_logits(config["model"], seed,
                                                 [p["prompt"] for p in picked], served, device)
    gaps = token_gaps(logits, served)
    return {name: {"value": NUMBERS[name](gaps), "limit": limit}
            for name, limit in limits.items()}


def control_gaps(reference, config: Dict, seed: int, picked: List[Dict], device):
    """The control: at each position of the same prompts and served tokens,
    the token that the configuration's module ``reference`` in float8
    (e4m3) puts first, and that token's gap under its float32 reference.
    Returns (the served tokens' gaps, the control's gaps)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts, served = [p["prompt"] for p in picked], [p["served"] for p in picked]
    with torch.no_grad():
        ref = reference.teacher_forced_logits(config["model"], seed, prompts, served, device)
        low = reference.teacher_forced_logits(config["model"], seed, prompts, served, device,
                                              quant="fp8")
    firsts = [lg.argmax(dim=-1).tolist() for lg in low]
    return token_gaps(ref, served), token_gaps(ref, firsts)
