"""Model assembly: the port of ``repro/models/model.py`` for every
architecture of the reference: dense decoders, MoE (GQA or MLA attention),
RWKV-6, the zamba2 hybrid, and the VLM and audio frontends.

``named_parameters()`` gives exactly the reference's
``collector.flatten_named(params)`` names (``embedding.word_embeddings``,
``final_norm``, ``layers.{i}.self_attention.linear_qkv.w``,
``layers.{i}.time_mix.mix_A``, ``mamba{g}.{j}.mixer.in_proj.w``,
``shared_attn.mlp.down.w``, ...), and the forward taps the reference's
names in the reference's order.  A hybrid's one shared attention block is
registered once, as ``shared_attn``, and applied at each shared segment
under that segment's scope (``shared_attn_{g}``): its gradients sum the
uses.  Sharding constraints have no counterpart on one card.

Rematerialization follows the reference's ``scan`` + ``jax.checkpoint``:
a segment the reference scans (``Segment.scan``: ``cfg.scan_layers`` and
more than one layer) runs each block under ``torch.utils.checkpoint``
when ``cfg.remat`` is set, grad is on and the trace context is off
(``remat_policy="dots"`` keeps the outputs of the 2-D matmuls, the
reference's ``dots_with_no_batch_dims_saveable``).  Recompute is the same
ops on the same inputs, so the values are bit-identical with and without
it.  A collecting context keeps every block's taps and does not remat;
the reference's scanned body gets no context and drops them.

``Model(cfg, device="meta")`` builds every leaf on the meta device (the
dry run's, ``launch/dryrun.py``): the same names, shapes and dtypes as a
CPU build, and nothing allocated.

Decode (``init_cache`` / ``decode_step``): caches are per-layer lists under
each segment's name (``{"layers": [cache of layer 0, ...]}``; each use of
the shared block has its own, ``{"shared_attn_{g}": [cache]}``), the
reference's layout at ``scan_layers=False``; its stacked ``scan_layers``
caches have no counterpart, as the port's parameters are per layer too.

The VLM and audio frontends are stubs, as in the reference: the batch
carries precomputed patch embeddings (``image_embeds``) or frame features
(``features``, with the bool ``mask`` of masked frames); ``vision_proj``,
``audio_proj``, ``mask_embed`` and the backbone are real.  An audio model
keeps the reference's unused ``embedding.word_embeddings``.
"""
from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.tap import ensure_ctx
from repro_torch.models.attention import (GQAttention, MLAttention,
                                          gqa_init_cache, mla_init_cache)
from repro_torch.models.layers import (GeluMLP, Linear, SwiGLUMLP, _logits,
                                       chunked_cross_entropy, cross_entropy,
                                       rmsnorm)
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import (Mamba2, RWKV6ChannelMix, RWKV6TimeMix,
                                    mamba2_init_state, rwkv6_init_state)

# the reference switches to chunked_cross_entropy above S * V = 2^26
_CHUNKED_CE_ELEMS = 1 << 26


@dataclass(frozen=True)
class Segment:
    name: str          # params key; also the tap scope
    kind: str          # attn_mlp | attn_dense_mlp | attn_moe | rwkv | mamba
                       # | shared_attn
    n: int             # number of layers in this segment
    layer0: int        # global index of the first layer (canonical naming)
    shared: bool = False  # params live under the shared key, not per-segment
    scan: bool = False    # the reference scans it (remat applies)


def build_plan(cfg: ArchConfig) -> list[Segment]:
    L = cfg.n_layers
    sc = cfg.scan_layers
    if cfg.arch_type in ("dense", "vlm", "audio", "moe") and \
            cfg.attn not in ("full", "swa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attn!r} is not ported yet")
    if cfg.arch_type in ("dense", "vlm", "audio"):
        return ([Segment("layers", "attn_mlp", L, 0, scan=sc and L > 1)]
                if L else [])
    if cfg.arch_type == "moe":
        nd = min(cfg.moe.n_dense_layers, L)
        segs = [Segment("dense_layers", "attn_dense_mlp", nd, 0)] if nd else []
        if L - nd > 0:
            segs.append(Segment("layers", "attn_moe", L - nd, nd,
                                scan=sc and L - nd > 1))
        return segs
    if cfg.arch_type == "ssm":
        return [Segment("layers", "rwkv", L, 0, scan=sc and L > 1)]
    if cfg.arch_type == "hybrid":
        # groups of attn_every mamba layers, each full one followed by a
        # use of the shared block; a partial last group has none
        k, segs, i, g = cfg.hybrid.attn_every, [], 0, 0
        while i < L:
            n = min(k, L - i)
            segs.append(Segment(f"mamba{g}", "mamba", n, i,
                                scan=sc and n > 1))
            i += n
            if n == k and cfg.hybrid.shared_attn:
                segs.append(Segment(f"shared_attn_{g}", "shared_attn", 1, i,
                                    shared=True))
            g += 1
        return segs
    raise ValueError(cfg.arch_type)


def _out_scale(cfg):  # megatron-style scaled residual-output init
    return 0.02 / math.sqrt(2.0 * max(cfg.n_layers, 1))


class Block(nn.Module):
    """``block_init`` / ``block_apply`` for the attention kinds:
    ``attn_mlp``, ``attn_dense_mlp`` (an MoE arch's leading dense layers,
    of width ``d_ff_dense``), ``attn_moe`` and a hybrid's ``shared_attn``,
    with GQA or (``attn == "mla"``) MLA attention; an ``audio`` arch's MLP
    is ``GeluMLP``, every other dense one ``SwiGLUMLP``.  ``forward`` gives
    ``(x, aux)``; ``aux`` is the MoE load-balance loss, ``None`` for a
    dense MLP.  ``step`` is the one-token decode."""

    def __init__(self, gen, cfg: ArchConfig, dtype, kind="attn_mlp"):
        super().__init__()
        osc = _out_scale(cfg)
        self.input_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype))
        self.post_attn_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype))
        self.mla = cfg.attn == "mla"
        attn = MLAttention if self.mla else GQAttention
        self.self_attention = attn(gen, cfg, dtype, osc)
        self.moe = kind == "attn_moe"
        if self.moe:
            self.mlp = MoE(gen, cfg, dtype, osc)
        elif kind != "attn_dense_mlp" and cfg.arch_type == "audio":
            self.mlp = GeluMLP(gen, cfg.d_model, cfg.d_ff, dtype, osc)
        else:
            d_ff = ((cfg.moe.d_ff_dense or cfg.d_ff) if kind == "attn_dense_mlp"
                    else cfg.d_ff)
            self.mlp = SwiGLUMLP(gen, cfg.d_model, d_ff, dtype, osc)

    def _run(self, x, ctx, attend, precision=None):
        """(x, aux, cache): ``attend(h)`` gives the attention's (output,
        cache)."""
        h = rmsnorm(self.input_norm, x)
        with ctx.scope("self_attention"):
            a, cache = attend(h)
        x = x + a
        h = rmsnorm(self.post_attn_norm, x)
        aux = None
        with ctx.scope("mlp"):
            if self.moe:
                mo, aux = self.mlp(h, ctx=ctx)
            else:
                mo = self.mlp(h, ctx=ctx, precision=precision)
        return x + mo, aux, cache

    def forward(self, x, ctx, use_kernel=False, precision=None):
        x, aux, _ = self._run(x, ctx, lambda h: (self.self_attention(
            h, ctx=ctx, use_kernel=use_kernel), None), precision)
        return x, aux

    def step(self, x, cache, pos, ctx, mla_impl="absorbed",
             mla_bugs=frozenset()):
        """One decode token: ``(x, cache)``.  ``mla_impl`` / ``mla_bugs``
        choose the MLA decode (``MLAttention.decode``); a GQA block takes
        neither."""
        kw = dict(impl=mla_impl, bugs=mla_bugs) if self.mla else {}
        x, _, cache = self._run(x, ctx, lambda h: self.self_attention.decode(
            h, cache, pos, **kw))
        return x, cache

    def init_cache(self, batch, seq_len, dtype, device=None):
        init = mla_init_cache if self.mla else gqa_init_cache
        return init(self.self_attention.cfg, batch, seq_len, dtype,
                    device or self.input_norm.device)


class RWKVBlock(nn.Module):
    """``block_init`` / ``block_apply`` for the ``rwkv`` kind.  As in the
    reference, ``use_kernel`` and ``precision`` do not reach it: a
    candidate puts the scan on the kernel by binding ``models.ssm.lin_attn``
    itself."""

    def __init__(self, gen, cfg: ArchConfig, dtype):
        super().__init__()
        osc = _out_scale(cfg)
        self.time_mix = RWKV6TimeMix(gen, cfg, dtype, osc)
        self.channel_mix = RWKV6ChannelMix(gen, cfg, dtype, osc)
        self.input_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype))
        self.post_tm_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype))

    def forward(self, x, ctx, use_kernel=False, precision=None):
        return self.step(x, None, None, ctx)[0], None

    def step(self, x, state, pos, ctx, mla_impl="absorbed",
             mla_bugs=frozenset()):
        """``(x, new state)`` from ``state`` (None: zeros).  One decode
        token or a whole sequence; the position is in the state, so
        ``pos`` is unused, and so are the MLA options (``Model.decode_step``
        refuses them on a non-MLA arch)."""
        st = state or {"time_mix": None, "channel_mix": None}
        h = rmsnorm(self.input_norm, x)
        with ctx.scope("time_mix"):
            tm, new_tm = self.time_mix(h, ctx=ctx, state=st["time_mix"])
        x = x + tm
        h = rmsnorm(self.post_tm_norm, x)
        with ctx.scope("channel_mix"):
            cm, new_cm = self.channel_mix(h, ctx=ctx,
                                          state=st["channel_mix"])
        return x + cm, {"time_mix": new_tm, "channel_mix": new_cm}

    def init_cache(self, batch, seq_len, dtype, device=None):
        return rwkv6_init_state(self.time_mix.cfg, batch, dtype,
                                device or self.input_norm.device)


class MambaBlock(nn.Module):
    """``block_init`` / ``block_apply`` for the ``mamba`` kind: a pre-norm
    Mamba2 mixer with a residual.  As for ``rwkv``, a candidate puts the
    scan on the kernel by binding ``models.ssm.lin_attn`` itself."""

    def __init__(self, gen, cfg: ArchConfig, dtype):
        super().__init__()
        self.input_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype))
        self.mixer = Mamba2(gen, cfg, dtype, _out_scale(cfg))

    def forward(self, x, ctx, use_kernel=False, precision=None):
        return self.step(x, None, None, ctx)[0], None

    def step(self, x, state, pos, ctx, mla_impl="absorbed",
             mla_bugs=frozenset()):
        """``(x, new state)`` from ``state`` (None: zeros), as
        ``RWKVBlock.step``."""
        h = rmsnorm(self.input_norm, x)
        with ctx.scope("mixer"):
            mo, new_state = self.mixer(h, ctx=ctx, state=state)
        return x + mo, new_state

    def init_cache(self, batch, seq_len, dtype, device=None):
        return mamba2_init_state(self.mixer.cfg, batch, dtype,
                                 device or self.input_norm.device)


def make_block(gen, cfg: ArchConfig, kind: str, dtype) -> nn.Module:
    if kind == "rwkv":
        return RWKVBlock(gen, cfg, dtype)
    if kind == "mamba":
        return MambaBlock(gen, cfg, dtype)
    return Block(gen, cfg, dtype, kind)


class Embedding(nn.Module):
    def __init__(self, gen, vocab, d_model, dtype):
        super().__init__()
        self.word_embeddings = nn.Parameter(
            (0.02 * torch.randn(vocab, d_model, generator=gen)).to(dtype))


def embed_tokens(w, tokens, cdtype, ctx=None):
    """The token embedding under the ``embedding`` scope, tapped as
    ``embedding/output`` in the compute dtype (``w``: (vocab, d))."""
    ctx = ensure_ctx(ctx)
    with ctx.scope("embedding"):
        h = F.embedding(tokens, w)
        h = ctx.tap("output", h.to(cdtype))
    return h


# the outputs of the matmuls without batch dims: the reference's
# ``dots_with_no_batch_dims_saveable``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(policy: str):
    """``checkpoint``'s ``context_fn`` for ``cfg.remat_policy``."""
    if policy == "full":
        return noop_context_fn
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _keep_dots)
    raise ValueError(f"unknown remat_policy {policy!r}")


class Model(nn.Module):
    """Parameters are drawn from a ``torch.Generator`` seeded with ``seed``
    (on the CPU, so one seed gives one model on every device) and live on
    ``device``."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        # on meta every leaf is made there; elsewhere on the CPU, then moved
        with (torch.device("meta") if dev.type == "meta"
              else contextlib.nullcontext()):
            self._build(cfg, seed)
        if dev.type != "meta":
            self.to(dev)

    def _build(self, cfg: ArchConfig, seed: int):
        self.cfg = cfg
        self.plan = build_plan(cfg)
        dtype = getattr(torch, cfg.param_dtype)
        self.cdtype = getattr(torch, cfg.compute_dtype)
        gen = torch.Generator().manual_seed(seed)
        self.embedding = Embedding(gen, cfg.vocab, cfg.d_model, dtype)
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                (0.02 * torch.randn(cfg.vocab, cfg.d_model, generator=gen)
                 ).to(dtype))
        if cfg.arch_type == "vlm":
            self.vision_proj = Linear(gen, cfg.vision_dim, cfg.d_model, dtype,
                                      bias=True)
        if cfg.arch_type == "audio":
            self.audio_proj = Linear(gen, cfg.audio_dim, cfg.d_model, dtype,
                                     bias=True)
            self.mask_embed = nn.Parameter(
                (0.02 * torch.randn(cfg.d_model, generator=gen)).to(dtype))
        # one ModuleList a segment, under the segment's name: an MoE arch's
        # leading dense layers are ``dense_layers.{j}``, as the reference
        # names their parameters (its taps use the global ``layers.{li}``);
        # a hybrid's shared block is one module, ``shared_attn``, built at
        # its first use
        self.layers = nn.ModuleList()
        for seg in self.plan:
            if not seg.shared:
                setattr(self, seg.name, nn.ModuleList(
                    make_block(gen, cfg, seg.kind, dtype)
                    for _ in range(seg.n)))
            elif not hasattr(self, "shared_attn"):
                self.shared_attn = make_block(gen, cfg, seg.kind, dtype)

    def scoped_blocks(self, seg: Segment):
        """``(tap scope, block)`` of each layer of ``seg``: ``layers.{li}``,
        or the shared block under the segment's own name."""
        if seg.shared:
            return [(seg.name, self.shared_attn)]
        return [(f"layers.{seg.layer0 + j}", block)
                for j, block in enumerate(getattr(self, seg.name))]

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def embed(self, batch, ctx=None):
        """The ``embedding`` scope's output, tapped in the compute dtype:
        token embeddings; an audio arch's projected ``features``, masked
        frames blended into ``mask_embed``; a VLM's projected
        ``image_embeds`` (when given) ahead of its token embeddings."""
        cfg = self.cfg
        if cfg.arch_type not in ("vlm", "audio"):
            return embed_tokens(self.embedding.word_embeddings,
                                batch["tokens"], self.cdtype, ctx)
        ctx = ensure_ctx(ctx)
        with ctx.scope("embedding"):
            if cfg.arch_type == "audio":
                h = self.audio_proj(batch["features"].to(self.cdtype))
                if "mask" in batch:
                    m = batch["mask"][..., None].to(self.cdtype)
                    h = h * (1 - m) + self.mask_embed.to(self.cdtype) * m
            else:
                h = F.embedding(batch["tokens"],
                                self.embedding.word_embeddings).to(self.cdtype)
                if "image_embeds" in batch:
                    img = self.vision_proj(
                        batch["image_embeds"].to(self.cdtype))
                    h = torch.cat([img, h], dim=1)
            return ctx.tap("output", h)

    def apply_blocks(self, h, ctx=None, use_kernel=False, precision=None):
        """``(final_norm_out, aux)``: ``aux`` sums the blocks' MoE
        load-balance losses (f32 zero without MoE blocks)."""
        ctx = ensure_ctx(ctx)
        remat = (self.cfg.remat and ctx.mode == "off"
                 and torch.is_grad_enabled())
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
        for seg in self.plan:
            for scope, block in self.scoped_blocks(seg):
                with ctx.scope(scope):
                    if remat and seg.scan:
                        h, aux = checkpoint(
                            block, h, ctx, use_kernel=use_kernel,
                            precision=precision, use_reentrant=False,
                            preserve_rng_state=False,
                            context_fn=_remat_context(self.cfg.remat_policy))
                    else:
                        h, aux = block(h, ctx, use_kernel=use_kernel,
                                       precision=precision)
                if aux is not None:
                    aux_total = aux_total + aux
        h = rmsnorm(self.final_norm, h)
        return ctx.tap("final_norm_out", h), aux_total

    def unembed(self, h):
        """Logits (..., vocab) in ``h``'s dtype."""
        e = (self.embedding.word_embeddings if self.cfg.tie_embeddings
             else self.lm_head)
        return _logits(h, e)

    def forward(self, batch, ctx=None, use_kernel=False, precision=None):
        """``use_kernel`` runs attention on the flash-attention kernel;
        ``precision`` (an optional ``precision.fp8.Precision``) routes the
        MLP matmuls through its FP8 recipe; everything else stays in the
        compute dtype.  Returns the final hidden states; ``loss`` adds
        the MoE load-balance loss ``apply_blocks`` gives beside them."""
        return self.apply_blocks(self.embed(batch, ctx), ctx,
                                 use_kernel=use_kernel,
                                 precision=precision)[0]

    def loss(self, batch, ctx=None, use_kernel=False, precision=None):
        """(ce + aux, {"ce", "aux"}): next-token CE, computed in sequence
        chunks of min(1024, S) when S * vocab > 2^26, as the reference,
        plus the MoE blocks' load-balance losses.  A VLM's CE takes the
        text positions only (the last ``labels.shape[1]``); an audio
        arch's is masked by the batch's ``mask``."""
        cfg = self.cfg
        h, aux = self.apply_blocks(self.embed(batch, ctx), ctx,
                                   use_kernel=use_kernel, precision=precision)
        e = (self.embedding.word_embeddings if cfg.tie_embeddings
             else self.lm_head)
        labels, mask = batch["labels"], batch.get("loss_mask")
        if cfg.arch_type == "vlm":
            h = h[:, -labels.shape[1]:]          # loss only on text positions
        if cfg.arch_type == "audio":
            mask = batch["mask"]
        if h.shape[1] * cfg.vocab > _CHUNKED_CE_ELEMS:
            ce = chunked_cross_entropy(h, e, labels, mask=mask,
                                       chunk=min(1024, h.shape[1]))
        else:
            ce = cross_entropy(_logits(h, e), labels, mask=mask)
        return ce + aux, {"ce": ce, "aux": aux}

    # ---- decode ---------------------------------------------------------------

    def init_cache(self, batch, seq_len, device=None):
        """``{segment name: [each layer's cache]}`` on ``device`` (default
        the model's; ``"meta"`` allocates nothing), in the compute dtype
        (the SSM scan states are f32); each use of a hybrid's shared block
        has its own.  A cache holds ``seq_len`` positions (a
        sliding-window arch's at most ``window``, as a ring)."""
        return {seg.name: [blk.init_cache(batch, seq_len, self.cdtype, device)
                           for _, blk in self.scoped_blocks(seg)]
                for seg in self.plan}

    @torch.no_grad()
    def decode_step(self, caches, tokens, pos: int, ctx=None,
                    mla_impl="absorbed", mla_bugs=frozenset()):
        """tokens: (B,1) int; ``pos``: their position.  Returns ``(logits
        (B,1,vocab), caches)``; attention caches are written in place.
        ``mla_impl`` / ``mla_bugs`` reach an MLA arch's attention
        (``MLAttention.decode``), the reference's ``MLA_DECODE_IMPL`` /
        ``MLA_DECODE_BUGS``; another arch refuses them."""
        if self.cfg.attn != "mla" and (mla_impl != "absorbed" or mla_bugs):
            raise ValueError(f"mla_impl={mla_impl!r} / mla_bugs="
                             f"{sorted(mla_bugs)} need attn 'mla', not "
                             f"{self.cfg.attn!r}")
        ctx = ensure_ctx(ctx)
        h = self.embed({"tokens": tokens}, ctx)
        new = {}
        for seg in self.plan:
            new[seg.name] = []
            for j, (scope, block) in enumerate(self.scoped_blocks(seg)):
                with ctx.scope(scope):
                    h, c = block.step(h, caches[seg.name][j], pos, ctx,
                                      mla_impl=mla_impl, mla_bugs=mla_bugs)
                new[seg.name].append(c)
        h = ctx.tap("final_norm_out", rmsnorm(self.final_norm, h))
        return self.unembed(h), new
