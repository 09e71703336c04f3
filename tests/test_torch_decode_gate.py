"""The decode check of ``chip_smoke.py``'s phase 17 (``family_decode_gate``)
on the CPU, at the families' smoke configs in bf16.

A right decode step holds. Where the decode step's router picks another
expert set than the forward's, the check aligns the forward with it and
asks that the flip be a near tie; a decode step whose top-k takes an
expert below the k-th without a tie must fail, whatever its logits read.
The file runs torch on one thread.
"""
import importlib.util
import os
from dataclasses import replace

import pytest
import torch

from repro_torch import configs as C
from repro_torch.models import lm as L
from repro_torch.models import moe as MOE
from repro_torch.models.nn import init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["olmoe-1b-7b", "qwen3-moe-235b-a22b", "zamba2-1.2b", "rwkv6-7b"]
MOE_FAMILIES = FAMILIES[:2]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model(arch: str):
    cfg = C.get_smoke_config(arch)
    if cfg.n_experts:       # phase 17's capacity E/k: no assignment drops
        cfg = replace(cfg, capacity_factor=cfg.n_experts
                      / cfg.n_experts_per_token)
    params = init_params(L.model_param_specs(cfg), seed=0, device="cpu")
    seq = torch.randint(0, cfg.vocab_size, (8, 40),
                        generator=torch.Generator().manual_seed(0))
    return params, seq, cfg


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_gate_holds_a_right_decode(smoke, arch):
    params, seq, cfg = _model(arch)
    gate = smoke.family_decode_gate(params, seq, cfg, smoke.LM_DECODE_BOUND)
    assert gate["ok"], gate
    assert gate["ratio"] < smoke.LM_DECODE_BOUND
    spread = smoke.forward_spread(params, seq, cfg)
    assert 0.0 <= spread < smoke.LM_DECODE_BOUND


@pytest.mark.parametrize("arch", MOE_FAMILIES)
def test_decode_gate_fails_a_top_k_that_is_no_tie(smoke, arch, monkeypatch):
    params, seq, cfg = _model(arch)
    route = MOE._route

    def wrong(x, w, c):
        gate, expert, tok, probs = route(x, w, c)
        if x.shape[0] == seq.shape[0]:  # the decode step: one token a row
            k = c.n_per_token
            order = torch.sort(probs[0], descending=True, stable=True)
            expert = expert.clone()
            expert[k - 1] = order.indices[k]   # row 0 takes its (k+1)-th
        return gate, expert, tok, probs
    monkeypatch.setattr(MOE, "_route", wrong)
    gate = smoke.family_decode_gate(params, seq, cfg, smoke.LM_DECODE_BOUND)
    assert gate["flipped"] == 1
    assert gate["tie_slack"] < 0
    assert not gate["ok"]
