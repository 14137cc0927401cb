"""dp×tp CLIP contrastive train step on `torch.distributed`.

Counterpart of `clip_retrieval_tpu/parallel/train.py`.  The JAX step lets
XLA insert the collectives of a `Mesh((dp, tp))`; here each rank is one
process holding its slice of the model, and the collectives are explicit
autograd functions.  Rank r sits at (r // tp, r % tp) of the dp×tp grid, as
the JAX mesh lays out its devices; the tp groups are the grid's rows and the
dp groups its columns.

- Megatron-style tensor parallelism over tp (`param_pspec`'s rules): the
  attention q/k/v projections and MLP `w_in` are column-parallel (each rank
  holds a slice of the output columns, i.e. heads/tp whole heads), the
  attention out-projection `wo` and MLP `w_out` row-parallel (a slice of
  the input rows), the token embedding is split by vocabulary, and every
  other parameter is replicated.  A column-parallel product is preceded by
  `_CopyToTP` (identity forward, all-reduce of the gradient); a row-parallel
  product is followed by `_ReduceFromTP` (all-reduce forward, identity
  backward) and then its bias, added once.
- Data parallelism over dp: each rank takes its share of the global batch,
  and the features are all-gathered over dp (`_GatherDP`, whose backward
  all-reduces the gradient and keeps this rank's rows) so that the loss is
  the symmetric InfoNCE over the global batch.  Gradients are then averaged
  over dp; with the gathered backward that average is the gradient of the
  global loss.
- The optimizer is `torch.optim.AdamW`, which computes what `optax.adamw`
  computes (eps added after the square root, decay on every parameter).

Attention takes the plain route (`attn_impl="xla"`), as the JAX step does:
kernel K1 has no backward (and refuses inputs that require grad).  The
backend is nccl on CUDA and gloo on the CPU; the caller opens the default
group (`init_pod`, or `init_process_group`) with dp·tp ranks.  A world of
one needs no group.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models import clip as tclip
from ..models.configs import CLIPConfig
from ..models.loaders import from_jax_params
from ..utils.device import resolve_device
from .dist import PG_TIMEOUT

COLUMN_PARALLEL = ("wq", "wk", "wv", "w_in")  # in block attention/MLP: output columns split
COLUMN_BIASES = ("bq", "bk", "bv", "b_in")
ROW_PARALLEL = ("wo", "w_out")  # input rows split; their biases stay replicated


def tp_dim(name: str) -> int | None:
    """The dim of parameter `name` (a `CLIP` module path) split over tp,
    None for a replicated one: the port's form of JAX `param_pspec` (whose
    block leaves carry a leading layer axis the port's modules do not)."""
    leaf = name.rsplit(".", 1)[-1]
    if ".blocks." in name:
        if leaf in COLUMN_PARALLEL:
            return 1
        if leaf in COLUMN_BIASES or leaf in ROW_PARALLEL:
            return 0
    if leaf == "token_emb":
        return 0  # vocab-split embedding table
    return None


class _CopyToTP(torch.autograd.Function):
    """Before a column-parallel product: identity forward, gradient summed
    over tp (each rank saw only its columns' share of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """After a row-parallel product: partial sums all-reduced over tp,
    gradient passed through (every rank needs all of it)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDP(torch.autograd.Function):
    """This rank's (b, E) features → the global (dp·b, E) batch in dp-rank
    order.  Every rank computes the same global loss, so the backward sums
    the ranks' identical gradients and keeps this rank's rows: dp times its
    share, which the average over dp of the parameter gradients divides
    out."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(dist.get_world_size(ctx.group))[dist.get_rank(ctx.group)], None


class _Comm:
    """This rank's place in the dp×tp grid and its two groups (None where
    the axis has one rank, so that no collective runs)."""

    def __init__(self, dp: int, tp: int):
        world = dp * tp
        if dist.is_initialized():
            if dist.get_world_size() != world:
                raise ValueError(f"dp={dp} x tp={tp} needs a world of {world} ranks, the group has "
                                 f"{dist.get_world_size()}")
            rank = dist.get_rank()
        elif world != 1:
            raise RuntimeError(f"dp={dp} x tp={tp} needs torch.distributed initialised with {world} ranks")
        else:
            rank = 0
        self.dp, self.tp = dp, tp
        self.dp_rank, self.tp_rank = divmod(rank, tp)
        self.tp_group = self.dp_group = None
        # every rank creates every group, in the same order
        if tp > 1:
            for d in range(dp):
                g = dist.new_group([d * tp + t for t in range(tp)], timeout=PG_TIMEOUT)
                if d == self.dp_rank:
                    self.tp_group = g
        if dp > 1:
            for t in range(tp):
                g = dist.new_group([d * tp + t for d in range(dp)], timeout=PG_TIMEOUT)
                if t == self.tp_rank:
                    self.dp_group = g

    def copy(self, x):
        return x if self.tp_group is None else _CopyToTP.apply(x, self.tp_group)

    def reduce(self, x):
        return x if self.tp_group is None else _ReduceFromTP.apply(x, self.tp_group)

    def gather(self, x):
        return x if self.dp_group is None else _GatherDP.apply(x, self.dp_group)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of the vocab-split table: each rank looks up the ids it owns,
        zeros for the others, summed over tp."""
        if self.tp_group is None:
            return table[tokens]
        n = table.shape[0]
        local = tokens - self.tp_rank * n
        owned = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)] * owned[..., None].to(table.dtype)
        return self.reduce(rows)


def _block(x: torch.Tensor, blk: tclip.Block, heads: int, comm: _Comm) -> torch.Tensor:
    """`Block.forward` on this rank's slices: `heads` local heads, row-parallel
    biases added after the reduce."""
    y = comm.copy(blk.ln_1(x, blk.eps))
    a = blk.attn
    q = tclip._dense(y, a.wq, a.bq)
    k = tclip._dense(y, a.wk, a.bk)
    v = tclip._dense(y, a.wv, a.bv)
    o = tclip.attn_ops.sdpa_packed(q, k, v, heads, causal=blk.causal, impl="xla")
    x = x + (comm.reduce(tclip.matmul_f32(o, a.wo)) + a.bo.float()).to(x.dtype)
    m = blk.mlp
    y = comm.copy(blk.ln_2(x, blk.eps))
    y = tclip._act(tclip._dense(y, m.w_in, m.b_in), blk.act)
    return x + (comm.reduce(tclip.matmul_f32(y, m.w_out)) + m.b_out.float()).to(x.dtype)


def _encode_image(model: tclip.CLIP, images: torch.Tensor, compute_dtype, comm: _Comm) -> torch.Tensor:
    """`encode_image` on this rank's slices (the ResNet tower is replicated)."""
    x = tclip.normalize_images(images, compute_dtype) if images.dtype == torch.uint8 else images.to(compute_dtype)
    cfg, v = model.cfg, model.visual
    if cfg.vision_kind == "resnet":
        return tclip.l2_normalize(v(x))
    p_sz, g, w = cfg.patch_size, cfg.grid_size, cfg.vision_width
    b = x.shape[0]
    x = x.reshape(b, g, p_sz, g, p_sz, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p_sz * p_sz * 3)
    x = tclip.matmul_f32(x, v.patch_embed.kernel.reshape(-1, w)).to(x.dtype)
    x = torch.cat([v.class_emb.to(x.dtype).expand(b, 1, w), x], dim=1) + v.pos_emb.to(x.dtype)
    x = v.ln_pre(x, cfg.layernorm_eps)
    for blk in v.blocks:
        x = _block(x, blk, cfg.vision_heads // comm.tp, comm)
    x = v.ln_post(x[:, 0], cfg.layernorm_eps)
    return tclip.l2_normalize(tclip.matmul_f32(x, v.proj))


def _encode_text(model: tclip.CLIP, tokens: torch.Tensor, compute_dtype, comm: _Comm) -> torch.Tensor:
    """`encode_text` on this rank's slices."""
    cfg, t = model.cfg, model.text
    tokens = tokens.long()
    x = comm.embed(t.token_emb, tokens).to(compute_dtype)
    x = x + t.pos_emb[: x.shape[1]].to(compute_dtype)
    for blk in t.blocks:
        x = _block(x, blk, cfg.text_heads // comm.tp, comm)
    x = t.ln_final(x, cfg.layernorm_eps)
    x = x[torch.arange(x.shape[0], device=x.device), torch.argmax(tokens, dim=-1)]
    return tclip.l2_normalize(tclip.matmul_f32(x, t.proj))


def clip_contrastive_loss(img_feats: torch.Tensor, txt_feats: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the (global) batch, logits in f32."""
    logits = scale * torch.matmul(img_feats.float(), txt_feats.float().T)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


def _check_split(cfg: CLIPConfig, tp: int):
    sizes = {"text_heads": cfg.text_heads, "vocab_size": cfg.vocab_size,
             "text_mlp": int(round(cfg.text_width * cfg.text_mlp_ratio))}
    if cfg.vision_kind != "resnet":
        sizes.update(vision_heads=cfg.vision_heads, vision_mlp=int(round(cfg.vision_width * cfg.vision_mlp_ratio)))
    bad = {k: v for k, v in sizes.items() if v % tp}
    if bad:
        raise ValueError(f"tp={tp} does not divide {bad}: the tensor-parallel split needs whole heads and equal slices")


def shard_model(model: tclip.CLIP, tp: int, tp_rank: int) -> tclip.CLIP:
    """Cut `model`'s parameters to rank `tp_rank`'s tp slices, in place, and
    make every parameter trainable."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = tp_dim(name)
            if dim is not None and tp > 1:
                p.data = p.data.chunk(tp, dim)[tp_rank].clone()
            p.requires_grad_(True)
    return model


def make_train_step(
    cfg: CLIPConfig,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.05,
    compute_dtype: torch.dtype = torch.float32,
    dp: int = 1,
    tp: int = 1,
    device: str | torch.device = "cuda",
):
    """Returns (init_fn, train_step) for this rank of a dp×tp world.

    init_fn(seed=0, jax_state=None) → (params, opt_state): this rank's slice
    of the model (a `CLIP` module) and its `torch.optim.AdamW`.  The full
    model comes from `init_clip(cfg, seed)` on the CPU, so every rank and
    device starts from the same weights; or, given `jax_state` (the JAX
    package's params and optax adamw `mu`, `nu`, `count` as numpy; see
    `from_jax_train_state`), from that state.
    train_step(params, opt_state, images, tokens) → (params, opt_state, loss):
    images (b, H, W, 3) uint8 and tokens (b, context_length) are this dp
    rank's share of the global batch (the tp ranks of a dp group pass the
    same rows); loss is the global batch's, before the update."""
    device = resolve_device(device)
    _check_split(cfg, tp)
    comm = _Comm(dp, tp)

    def init_fn(seed: int = 0, jax_state: Mapping[str, Any] | None = None):
        if jax_state is not None:
            return from_jax_train_state(jax_state, cfg, learning_rate=learning_rate, weight_decay=weight_decay,
                                        tp=tp, tp_rank=comm.tp_rank, device=device)
        model = shard_model(tclip.init_clip(cfg, seed, device="cpu"), tp, comm.tp_rank).to(device)
        return model, torch.optim.AdamW(model.parameters(), lr=learning_rate, weight_decay=weight_decay)

    def train_step(params: tclip.CLIP, opt_state: torch.optim.AdamW, images: torch.Tensor, tokens: torch.Tensor):
        opt_state.zero_grad(set_to_none=True)
        img = comm.gather(_encode_image(params, images.to(device), compute_dtype, comm))
        txt = comm.gather(_encode_text(params, tokens.to(device), compute_dtype, comm))
        loss = clip_contrastive_loss(img, txt, params.logit_scale.exp())
        loss.backward()
        if comm.dp_group is not None:
            grads = [p.grad for p in params.parameters()]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=comm.dp_group)
            flat /= dp
            for g, avg in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(avg.view_as(g))
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, train_step


def from_jax_train_state(
    jax_state: Mapping[str, Any],
    cfg: CLIPConfig,
    *,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.05,
    tp: int = 1,
    tp_rank: int = 0,
    device: str | torch.device = "cuda",
):
    """The JAX package's train state → this rank's (params, AdamW).

    `jax_state` holds numpy trees: "params" (the JAX param tree), "mu" and
    "nu" (optax adamw's `ScaleByAdamState` moments, trees like params) and
    "count" (its step count).  They become the module's parameters and the
    optimizer's `exp_avg`, `exp_avg_sq` and `step`, each cut to rank
    `tp_rank`'s tp slice."""
    device = resolve_device(device)
    model = shard_model(from_jax_params(jax_state["params"], cfg, device="cpu"), tp, tp_rank).to(device)
    mu = shard_model(from_jax_params(jax_state["mu"], cfg, device="cpu"), tp, tp_rank)
    nu = shard_model(from_jax_params(jax_state["nu"], cfg, device="cpu"), tp, tp_rank)
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate, weight_decay=weight_decay)
    for p, m, v in zip(model.parameters(), mu.parameters(), nu.parameters()):
        opt.state[p] = {"step": torch.tensor(float(jax_state["count"])), "exp_avg": m.detach().to(device),
                        "exp_avg_sq": v.detach().to(device)}
    return model, opt
