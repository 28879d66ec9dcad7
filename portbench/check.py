"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed, a sample of the requests that finished in it
(drawn from the seed, with the longest in it, until it holds
``check_tokens`` served tokens) is run through the reference: one causal
pass in float32 over each prompt and its served tokens.  Each served
token's logit is read against the reference's best at its position; the
widest gap (``logit_gap_max``) or the mean gap (``logit_gap_mean``) over
the sample, as ``limits/<cell>.json`` names them, is compared with the
cell's limit.  Every answer of the window must also have its full
length.  The control reads the same gaps for the token that the
reference in fp8 puts first at each position.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench.reference.common import Precision


def reference(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def sample(run, seed: int) -> list:
    """The requests the check runs: the longest that finished in the
    window, then others in an order drawn from the seed, until they hold
    ``check_tokens`` served tokens."""
    done = sorted((q for q in run.requests.values()
                   if q.ended is not None and run.in_window(q.ended)), key=lambda q: q.rid)
    if not done:
        return []
    longest = max(done, key=lambda q: (q.prompt_len + len(q.tokens), q.rid))
    rest = [q for q in done if q is not longest]
    order = np.random.default_rng(np.random.SeedSequence([int(seed), 4])).permutation(len(rest))
    out, served = [longest], len(longest.tokens)
    for i in order:
        if served >= run.spec["check_tokens"]:
            break
        out.append(rest[i])
        served += len(rest[i].tokens)
    return out


def _gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best, per row."""
    return ref_logits.max(dim=-1).values - ref_logits.gather(1, tokens[:, None])[:, 0]


def gaps(params: dict, cfg: dict, reqs: list, control: bool = False) -> dict:
    """The widest and the mean gap of the served tokens over ``reqs`` and,
    with ``control``, of the tokens the fp8 reference puts first."""
    ref = reference(cfg)
    device = params["embed.table"].device
    served, low = [], []
    for q in reqs:
        prompt = torch.as_tensor(q.prompt, device=device)
        tokens = torch.as_tensor(np.asarray(q.tokens, np.int64), device=device)
        with torch.inference_mode():
            lg = ref.served_logits(params, cfg, prompt, tokens)
            served.append(_gap(lg, tokens).cpu())
            if control:
                pick = ref.served_logits(params, cfg, prompt, tokens, Precision(control=True))
                low.append(_gap(lg, pick.argmax(dim=-1)).cpu())
    out = {"tokens": sum(g.numel() for g in served), "requests": len(reqs)}
    for name, found in (("logit_gap", served), ("control_gap", low)):
        if found:
            cat = torch.cat(found)
            out[f"{name}_max"], out[f"{name}_mean"] = float(cat.max()), float(cat.mean())
    return out


def check_run(run, params: dict, cfg: dict, seed: int, limits: dict, log,
              control: bool = False) -> dict:
    """The numbers compared, each beside its limit (the names and limits
    of ``limits/<cell>.json``); with ``control`` also the readings of both
    sides, compared with nothing."""
    reqs = sample(run, seed)
    read = gaps(params, cfg, reqs, control)
    short = sum(1 for q in run.requests.values()
                if q.ended is not None and run.in_window(q.ended) and len(q.tokens) != q.max_new)
    log(f"checked {read['requests']} requests, {read['tokens']} served tokens; readings "
        f"logit_gap_max {read.get('logit_gap_max')!r} logit_gap_mean {read.get('logit_gap_mean')!r}")
    out = {"answers_cut_short": {"value": short, "limit": 0},
           "no_answer_checked": {"value": int(not reqs), "limit": 0}}
    for name, spec in limits.items():
        out[name] = {"value": read.get(name, float("inf")), "limit": spec["limit"]}
    if control:
        for name in ("logit_gap_max", "logit_gap_mean", "control_gap_max", "control_gap_mean"):
            out.setdefault(name, {"value": read.get(name), "limit": None})
    return out
