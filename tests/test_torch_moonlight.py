"""The port's DeepSeek-V3 block (``moonlight-16b-a3b``, a port-only
config) on the CPU at a tiny size, against the plain float32 model of
``tests/plain_deepseek_v3.py``:

* the plain model's loss, gradients and first AdamW update on seeded
  weights, with the held share from an offset and a bias that moves the
  router's choice;
* the held share: over all shares of the experts, the held partials plus
  the shared experts counted once give the uncut layer;
* the router: the score-correction bias moves the choice and never the
  weights (nor takes a gradient), the chosen weights are renormalized
  and scaled, exact ties go to the lower expert;
* the tp2 candidate (MLA heads and held experts over tp, dp2·tp2 too) is
  clean, and three faults planted in it are flagged and localized to
  their module: ``kv_lora_norm``'s gradient not summed over tp, the
  shared experts' output not reduced, the bias ignored by one rank;
* under a check the ``moe`` and ``mla`` spans time the backward too, and
  ``moe.rows_held`` / ``moe.dropped`` count what routing gave the held
  experts.
"""
import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import plain_deepseek_v3 as plain  # noqa: E402
from repro_torch.configs.base import MoEConfig, get_config  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core.collector import named_params, trace_train_step  # noqa: E402
from repro_torch.core.harness import make_model_runner, ttrace_check  # noqa: E402
from repro_torch.core.tap import ensure_ctx  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel import api, gpt  # noqa: E402
from repro_torch.parallel.api import ParallelConfig, make_candidate_runner  # noqa: E402
from repro_torch.parallel.layers import tp_swiglu_mlp  # noqa: E402

B, S = 2, 32
LR = 1e-3


def setup_module():
    torch.set_num_threads(1)


def tiny_cfg(**moe):
    """Reduced ``moonlight-16b-a3b``: 3 layers (the dense one, then 2
    MoE), 8 experts choosing 3, 4 of them held from expert 2, capacity
    factor 2."""
    cfg = get_config("moonlight-16b-a3b").reduced()
    kw = dict(n_experts=8, top_k=3, n_shared=2, capacity_factor=2.0,
              n_held=4, held_offset=2, router_aux_coef=0.05)
    kw.update(moe)
    return dataclasses.replace(cfg, n_layers=3,
                               moe=dataclasses.replace(cfg.moe, **kw))


def tiny_model(cfg, seed=3, bias_std=0.05):
    model = Model(cfg, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for blk in model.layers:
            b = blk.mlp.score_correction.b
            b.copy_(bias_std * torch.randn(b.shape, generator=gen))
    return model


def tiny_batch(cfg, seed=1):
    toks = torch.randint(0, cfg.vocab, (B, S + 1),
                         generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def hp(cfg):
    m, a = cfg.moe, cfg.mla
    return dict(d_model=cfg.d_model, n_heads=cfg.n_heads,
                kv_lora_rank=a.kv_lora_rank, qk_nope_dim=a.qk_nope_dim,
                qk_rope_dim=a.qk_rope_dim, v_head_dim=a.v_head_dim,
                rope_theta=cfg.rope_theta, n_dense_layers=m.n_dense_layers,
                n_moe_layers=cfg.n_layers - m.n_dense_layers,
                n_experts=m.n_experts, top_k=m.top_k, n_held=m.held,
                held_offset=m.held_offset, capacity_factor=m.capacity_factor,
                routed_scaling_factor=m.routed_scaling_factor,
                aux_coef=m.router_aux_coef)


# ---------------------------------------------------------------------------
# the plain model against the plain float32 reference
# ---------------------------------------------------------------------------

def test_plain_model_matches_the_plain_reference():
    cfg = tiny_cfg()
    model = tiny_model(cfg)
    batch = tiny_batch(cfg)
    tr, _, _ = trace_train_step(model, batch, opt=AdamW(lr=LR))
    params = {k: v.detach().clone().requires_grad_()
              for k, v in named_params(model).items()}
    loss = plain.loss(params, batch["tokens"], batch["labels"], hp(cfg))
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}
    assert float(tr.loss) == pytest.approx(float(loss.detach()), rel=1e-6)
    assert set(tr.param_grads) == set(grads)
    # float32 sums in another order: each leaf's gradient within 1e-5 of
    # its norm, and so its update, whose elements are sign(g) lr at the
    # first step (a tiny g may flip, so the update's gap is 1e-3 of its
    # norm)
    bias = "layers.0.mlp.score_correction.b"
    for k, g in grads.items():
        if k.endswith("score_correction.b"):
            continue
        gap = float((tr.param_grads.raw(k) - g).norm() / g.norm())
        assert gap < 1e-5, (k, gap)
    assert not tr.param_grads.raw(bias).any() and not grads[bias].any()
    post = plain.adamw_first_step({k: p.detach() for k, p in params.items()},
                                  grads, LR)
    for k, p in post.items():
        moved = p - params[k].detach()
        got = tr.params_post.raw(k) - params[k].detach()
        if k.endswith("score_correction.b"):
            assert not got.any() and not moved.any()
            continue
        assert float((got - moved).norm() / moved.norm()) < 1e-3, k


def test_held_shares_add_up_to_the_uncut_layer():
    """Each of 4 shares of 2 experts computes its part of the layer for
    the tokens routed to its experts; their sum, with the shared experts
    counted once, is the reference's uncut layer of all 8."""
    full = tiny_cfg(n_held=0, held_offset=0)
    model = tiny_model(full)
    blk = model.layers[0].mlp
    h = torch.randn(B, S, full.d_model,
                    generator=torch.Generator().manual_seed(5))
    p = {k: v.detach() for k, v in blk.named_parameters()}
    want, want_aux = plain.moe_layer(h, p, hp(full), n_held=8, held_offset=0)
    shared = blk.shared(h).detach()
    parts, n = [], 4
    for r in range(n):
        m = dataclasses.replace(full.moe, n_held=2, held_offset=2 * r)
        share = tmoe.MoE(torch.Generator(), dataclasses.replace(full, moe=m),
                         torch.float32)
        share.load_state_dict({
            k: (v[2 * r:2 * r + 2] if k.startswith("experts.") else v)
            for k, v in blk.state_dict().items()})
        y, aux = share(h)
        parts.append(y.detach())
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    got = sum(parts) - (n - 1) * shared
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    # one share alone is not the layer
    assert not torch.allclose(parts[0], want, atol=1e-3)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def _m(**kw):
    base = dict(n_experts=6, top_k=2, scoring="sigmoid",
                routed_scaling_factor=2.5)
    base.update(kw)
    return MoEConfig(**base)


def test_bias_moves_the_choice_not_the_weights():
    s = torch.tensor([[0.9, 0.8, 0.7, 0.1, 0.2, 0.3]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.75])
    m = _m()
    p0, e0 = tmoe.select_topk(s, m)
    p1, e1 = tmoe.select_topk(s, m, bias)
    assert e0.tolist() == [[0, 1]] and e1.tolist() == [[5, 0]]
    # weighed by the scores alone: 2.5 * s_i / (s_5 + s_0)
    assert torch.allclose(p1, 2.5 * torch.tensor([[0.3, 0.9]]) / 1.2)
    # and the bias takes no gradient through the choice
    b = bias.clone().requires_grad_()
    sv = s.clone().requires_grad_()
    w, _ = tmoe.select_topk(sv, m, b)
    w.sum().backward()
    assert b.grad is None and sv.grad is not None


def test_norm_topk_prob_and_scale():
    """The published ``norm_topk_prob: true``: the chosen scores are
    renormalized, then scaled."""
    s = torch.tensor([[0.2, 0.6, 0.4, 0.1]])
    p, e = tmoe.select_topk(s, _m(n_experts=4))
    assert e.tolist() == [[1, 2]]
    assert torch.allclose(p, 2.5 * torch.tensor([[0.6, 0.4]]))
    p, _ = tmoe.select_topk(s, _m(n_experts=4, routed_scaling_factor=1.0))
    assert torch.allclose(p.sum(-1), torch.ones(1))
    # the default config keeps the reference's softmax router bit for bit
    logits = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
    d = MoEConfig(n_experts=8, top_k=2)
    got = tmoe.route(logits, d)
    want = tmoe.router_topk(logits, 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], torch.softmax(logits, -1))


def test_exact_ties_go_to_the_lower_expert():
    s = torch.tensor([[0.5, 0.4, 0.5, 0.4, 0.5]])
    _, e = tmoe.select_topk(s, _m(n_experts=5, top_k=3))
    assert e.tolist() == [[0, 2, 4]]
    bias = torch.tensor([0.0, 0.1, 0.0, 0.1, 0.0])   # 0.4 + 0.1 ties 0.5
    _, e = tmoe.select_topk(s, _m(n_experts=5, top_k=3), bias)
    assert e.tolist() == [[0, 1, 2]]


# ---------------------------------------------------------------------------
# the tp2 candidate and three planted faults
# ---------------------------------------------------------------------------

def _check(cfg, pcfg, model=None, localize=True):
    model = model or tiny_model(cfg)
    opt = AdamW(lr=LR)
    return ttrace_check(make_model_runner(model, opt, device="cpu"),
                        make_candidate_runner(cfg, pcfg, model, opt,
                                              device="cpu"),
                        tiny_batch(cfg), localize=localize)


@pytest.mark.parametrize("pcfg", [dict(tp=2), dict(tp=2, sp=True),
                                  dict(dp=2, tp=2)],
                         ids=["tp2", "tp2sp", "dp2tp2"])
def test_clean_candidate_passes(pcfg):
    cfg = tiny_cfg()
    if "dp" in pcfg:
        # dp halves each routing's tokens, so the capacity too: dropless
        cfg = tiny_cfg(capacity_factor=0.0)
    res = _check(cfg, ParallelConfig(**pcfg), localize=False)
    assert res.passed, res.summary()


def test_candidate_refuses_context_parallel_mla():
    cfg = tiny_cfg()
    with pytest.raises(ValueError, match="context-parallel MLA"):
        make_candidate_runner(cfg, ParallelConfig(cp=2), tiny_model(cfg),
                              device="cpu")


def _kv_norm_unreduced(monkeypatch):
    needs = api._needs_tp_reduce
    monkeypatch.setattr(api, "_needs_tp_reduce", lambda name, pcfg: (
        False if name.endswith("kv_lora_norm") else needs(name, pcfg)))


def _shared_unreduced(monkeypatch):
    # tp_moe calls the shared experts' MLP without a ctx (no taps of its
    # own); a dense layer's MLP passes its block's
    def mlp(mesh, p, x, sp, bugs=frozenset(), ctx=None):
        if ctx is None:
            bugs = bugs | {"tp_missing_row_psum"}
        return tp_swiglu_mlp(mesh, p, x, sp, bugs=bugs, ctx=ctx)
    monkeypatch.setattr(gpt, "tp_swiglu_mlp", mlp)


def _bias_ignored_by_rank_1(monkeypatch):
    own = gpt.router_bias

    def ignored(p_local):
        b = own(p_local)
        # tp 2 alone: the rank axis is the tp axis
        keep = (torch.arange(b.shape[0]) != 1).to(b.dtype)
        return b * keep[:, None, None]
    monkeypatch.setattr(gpt, "router_bias", ignored)


FAULTS = {"kv_lora_norm_grad_unreduced": (
              _kv_norm_unreduced, "layers.1.self_attention.kv_lora_norm"),
          "shared_output_unreduced": (_shared_unreduced, "layers.1.mlp"),
          "bias_ignored_by_one_rank": (_bias_ignored_by_rank_1,
                                       "layers.1.mlp")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_flagged_and_localized(fault, monkeypatch):
    plant, module = FAULTS[fault]
    plant(monkeypatch)
    res = _check(tiny_cfg(), ParallelConfig(tp=2))
    assert not res.passed
    assert res.localized_module == module, res.summary()


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

def test_spans_time_the_backward_and_counters_count_the_held_rows(
        monkeypatch):
    cfg = tiny_cfg()
    model = tiny_model(cfg)
    closed = []
    close = spans._Backward.close
    monkeypatch.setattr(spans._Backward, "close",
                        lambda self: (closed.append(self.key), close(self)))
    res = _check(cfg, ParallelConfig(tp=2), model=model, localize=False)
    assert res.passed
    n_moe, n_mla = cfg.n_layers - cfg.moe.n_dense_layers, cfg.n_layers
    # two estimate runs and the candidate: each layer's backward once a run
    assert sorted(set(closed)) == ["candidate.mla", "candidate.moe",
                                   "estimate.mla", "estimate.moe"]
    assert closed.count("estimate.moe") == 2 * n_moe
    assert closed.count("candidate.mla") == n_mla
    for key in ("estimate.moe", "estimate.mla", "candidate.moe",
                "candidate.mla"):
        assert res.seconds[key] > 0
    # the held rows, counted again from the plain model's routing
    m = cfg.moe
    rows = dropped = 0
    batch = tiny_batch(cfg)
    with torch.no_grad():
        h = model.embed(batch)
        cap = tmoe.expert_capacity(B * S, m)
        for _, blk in model.scoped_blocks(model.plan[0]) + \
                model.scoped_blocks(model.plan[1]):
            x = h + blk.self_attention(plain.rms(h, blk.input_norm))
            if blk.moe:
                hn = plain.rms(x, blk.post_attn_norm).reshape(B * S, -1)
                _, top_e, _ = tmoe.route(hn @ blk.mlp.router, m,
                                         blk.mlp.score_correction.b)
                n = torch.stack([(top_e == e).sum() for e in range(
                    m.held_offset, m.held_offset + m.held)])
                rows += int(n.sum())
                dropped += int(torch.clamp(n - cap, min=0).sum())
            h, _ = blk(h, ensure_ctx(None))
    assert res.counts["candidate.moe.rows_held"] == rows > 0
    assert res.counts["candidate.moe.dropped"] == dropped
    assert res.counts["estimate.moe.rows_held"] == 2 * rows


@pytest.mark.cuda
def test_card_spans_time_the_backward_on_the_device_clock(monkeypatch):
    """On CUDA autograd runs the backward on its device thread, which sees
    no context variable: the edges hold the log, and their events land on
    the device's clock under the check's keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward runs on autograd's "
                    "device thread there")
    cfg = tiny_cfg()
    model = tiny_model(cfg).to("cuda")
    closed = []
    close = spans._Backward.close
    monkeypatch.setattr(spans._Backward, "close",
                        lambda self: (closed.append(self.key), close(self)))
    opt = AdamW(lr=LR)
    batch = {k: v.cuda() for k, v in tiny_batch(cfg).items()}
    res = ttrace_check(make_model_runner(model, opt, device="cuda"),
                       make_candidate_runner(cfg, ParallelConfig(tp=2), model,
                                             opt, device="cuda"),
                       batch, localize=False)
    assert res.passed
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers
    assert closed.count("estimate.moe") == 2 * n_moe
    assert closed.count("candidate.mla") == cfg.n_layers
    for key in ("estimate.moe", "estimate.mla", "candidate.moe",
                "candidate.mla"):
        assert 0 < res.seconds[key] < res.seconds[key.split(".")[0]]
    assert res.counts["estimate.moe.rows_held"] == \
        2 * res.counts["candidate.moe.rows_held"] > 0
