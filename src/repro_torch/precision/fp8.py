"""FP8 (e4m3) training recipes and the stale-scale silent bug (paper §6.7,
bug 8): the port of ``repro/precision/fp8.py``.

FP8 matmuls quantize operands to ``float8_e4m3fn`` with an amax-derived
scale and accumulate in f32, so the machine epsilon that governs threshold
estimation is still BF16's (``MACHINE_EPS["float8_e4m3fn"]``).  Recipes:

  * "global":      one scale for the whole tensor (TransformerEngine default)
  * "per_tensor":  alias of global here (per-operand scale)
  * "tile128":     one scale per 128x128 tile (the DeepSeek-V3 recipe)

``fp8_linear`` drops into the MLPs when a ``Precision`` recipe asks for it
(``models.layers`` threads it through the model).  The quantized product
runs through ``kernels.ops``: the hand-written kernel on the card, its
plain version on the CPU.  There is no ``use_kernel`` switch; the port
always takes the reference's kernel route, including its rule that tile128
shapes not divisible by 128 take the per-element dequant matmul.

``make_fp8_runner`` is the candidate factory: the SAME model with FP8 MLP
matmuls, checked against the full-precision reference under BF16-epsilon
thresholds.

Bug 8 ("AR: wrong tensor by FP8 cast"): quantization uses a STALE amax,
modelled by halving the amax of x: values clip, the loss is silently wrong.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

E4M3_MAX = 448.0
F8 = torch.float8_e4m3fn
TILE = 128
FP8_RECIPES = ("global", "per_tensor", "tile128")


@dataclass(frozen=True)
class Precision:
    """Numeric recipe threaded through the model MLPs (None = full
    precision).  ``stale_scale`` is bug 8's injection point."""
    fp8_recipe: Optional[str] = None
    stale_scale: bool = False

    def __post_init__(self):
        if self.fp8_recipe is not None and self.fp8_recipe not in FP8_RECIPES:
            raise ValueError(f"unknown fp8 recipe {self.fp8_recipe!r}")


def _tile_amax(ax):
    """Per-128x128-tile max of ``ax`` -> compact (..., M/tm, N/tn) tensor."""
    M, N = ax.shape[-2], ax.shape[-1]
    tm, tn = min(TILE, M), min(TILE, N)
    axp = F.pad(ax, (0, -N % tn, 0, -M % tm))
    Mp, Np = axp.shape[-2], axp.shape[-1]
    t = axp.reshape(*axp.shape[:-2], Mp // tm, tm, Np // tn, tn)
    return t.amax(dim=(-3, -1))


def expand_tile_scale(scale, shape):
    """Broadcast a compact per-tile scale back to the full operand shape.

    Tiles are the fixed ``min(TILE, dim)`` size ``_tile_amax`` grouped by
    (the LAST tile is the ragged one)."""
    M, N = shape[-2], shape[-1]
    tm, tn = min(TILE, M), min(TILE, N)
    full = scale.repeat_interleave(tm, dim=-2).repeat_interleave(tn, dim=-1)
    return full[..., :M, :N]


def _amax(x, recipe: str):
    ax = x.float().abs()
    if recipe in ("global", "per_tensor"):
        return ax.amax()
    if recipe == "tile128":
        return _tile_amax(ax)
    raise ValueError(recipe)


def quantize_e4m3(x, recipe: str = "global", stale_scale: bool = False):
    """Returns ``(q, scale)`` with ``x ~= q.float() * scale``: ``scale`` is
    a 0-d tensor for global/per_tensor and the COMPACT per-128-tile tensor
    for tile128 (``expand_tile_scale`` maps it back to the operand shape).
    Every step is f32 and the cast rounds to nearest even, as in the
    reference, so both give the same bytes."""
    amax = _amax(x, recipe)
    if stale_scale:
        amax = amax * 0.5          # bug 8: scale from a stale (smaller) amax
    scale = torch.clamp(amax, min=1e-12) / E4M3_MAX
    full = expand_tile_scale(scale, x.shape) if recipe == "tile128" else scale
    q = torch.clamp(x.float() / full, -E4M3_MAX, E4M3_MAX)
    return q.to(F8), scale


def _kernel_tileable(x, w) -> bool:
    return (x.dim() == 2 and w.dim() == 2
            and x.shape[0] % TILE == 0 and x.shape[1] % TILE == 0
            and w.shape[1] % TILE == 0)


def fp8_matmul(x, w, recipe: str = "global", stale_scale: bool = False):
    """x: (M,K) @ w: (K,N) with fp8 operands, f32 accumulation -> f32."""
    qx, sx = quantize_e4m3(x, recipe, stale_scale=stale_scale)
    qw, sw = quantize_e4m3(w, recipe)
    if recipe == "tile128":
        # per-tile scales vary along K, so they cannot be folded outside
        # the contraction: the kernel applies them per 128-block; shapes it
        # cannot tile are dequantized per element (the reference's rule)
        if _kernel_tileable(qx, qw):
            return kops.fp8_matmul_tile128(qx, sx, qw, sw)
        xd = qx.float() * expand_tile_scale(sx, qx.shape)
        wd = qw.float() * expand_tile_scale(sw, qw.shape)
        return xd @ wd
    return kops.fp8_matmul(qx, qw) * (sx * sw)


class _FP8Linear(torch.autograd.Function):
    """fp8 forward; straight-through backward from the unquantized operands
    (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, w, recipe, stale_scale):
        ctx.save_for_backward(x, w)
        y = fp8_matmul(x.reshape(-1, x.shape[-1]), w, recipe,
                       stale_scale=stale_scale)
        return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = (g @ w.T.to(g.dtype)).to(x.dtype)
        gw = torch.einsum("...i,...o->io", x.float(), g.float()).to(w.dtype)
        return gx, gw, None, None


def fp8_linear(w, x, recipe: str = "global", stale_scale: bool = False):
    """``x @ w`` with an fp8 forward and a bf16/f32 straight-through
    backward (the standard TransformerEngine training arrangement)."""
    return _FP8Linear.apply(x, w, recipe, stale_scale)


# ---------------------------------------------------------------------------
# Candidate factory
# ---------------------------------------------------------------------------

def fp8_precision(recipe: str, bugs=frozenset()) -> Precision:
    from repro_torch.bugs.registry import BUGS
    unknown = set(bugs) - set(BUGS)
    if unknown:
        raise KeyError(f"unknown bug ids {sorted(unknown)}")
    return Precision(fp8_recipe=recipe,
                     stale_scale="fp8_stale_scale" in bugs)


def make_fp8_runner(model, recipe: str, opt=None, opt_state=None,
                    bugs=frozenset(), device="cuda") -> Callable:
    """Runner(batch, rewrites) -> Trace: ``model`` with FP8 MLP matmuls.
    The model's parameters are never changed by a run."""
    from repro_torch.core.collector import named_params, trace_fn_step
    from repro_torch.core.harness import inputs_on, runner_device
    dev = runner_device(model, device)
    precision = fp8_precision(recipe, bugs)
    params = named_params(model)

    def loss_call(batch, ctx):
        return model.loss(batch, ctx=ctx, precision=precision)[0]

    def run(batch, rewrites=None):
        b, rw = inputs_on(dev, batch, rewrites)
        tr, _, _ = trace_fn_step(loss_call, params, b, opt=opt,
                                 opt_state=opt_state, rewrites=rw)
        return tr

    return run


def make_fp8_train_step(model, opt, recipe: str, bugs=frozenset(),
                        device="cuda"):
    """The FP8 candidate's train step over state threaded by the caller
    (the supervisor's contract): ``model`` with FP8 MLP matmuls, its own
    parameters the leaves the state is copied into.

    Returns ``(step, params0, opt_state0)`` with ``step(params, opt_state,
    batch) -> (Trace, new_params, new_opt_state)``; it trains under the
    full-precision reference with BF16-epsilon thresholds (paper §6.7)."""
    from repro_torch.core.collector import make_trace_step, named_params
    from repro_torch.core.harness import runner_device
    runner_device(model, device)
    precision = fp8_precision(recipe, bugs)
    params = named_params(model)

    def loss_call(batch, ctx):
        return model.loss(batch, ctx=ctx, precision=precision)[0]

    params0 = {k: p.detach().clone() for k, p in params.items()}
    return (make_trace_step(loss_call, opt, params), params0,
            opt.init(params0))
