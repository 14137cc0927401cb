"""The port's dp×tp contrastive train step (`parallel/train.py`) against the JAX
package's, on the CPU at TEST_TINY.

- Loss and gradients of one step at (dp, tp) ∈ {(1,1), (2,1), (1,2), (2,2)}:
  each rank is its own process on a `gloo` group (a `FileStore` under the
  test's tmp_path, one thread per rank, a timeout on every process and on
  the group), from the JAX params carried across, each dp rank with its
  share of one global batch of 8.  Every rank's loss must equal JAX's
  `jax.value_and_grad` of `clip_contrastive_loss ∘ clip_forward(attn_impl=
  "xla")` on the same params and batch to rtol 2e-4 (the JAX package's own
  bar, tests/test_parallel/test_train_multichip.py), and every gradient leaf
  the rank holds must have cosine ≥ 0.9999 with JAX's gradient cut to the
  same slice.  A leaf whose JAX gradient is zero in exact arithmetic (the
  attention key biases: softmax is invariant to them) is held to |g| ≤ 1e-5
  instead, where a cosine means nothing.
- Three steps of the port from a JAX train state carried across (params and
  optax adamw's mu, nu and count after one JAX step) track three steps of
  JAX's `make_train_step` on a 1×1 mesh (run in a fresh interpreter, as
  tests/test_parallel does) to loss rtol 1e-3.
- `torch.optim.AdamW` equals `optax.adamw` on one leaf over five steps.
- Kernel K1 refuses inputs that require grad; the plain route trains.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_retrieval_tpu.models import clip as jclip
from clip_retrieval_tpu.models.configs import TEST_TINY as JTINY
from clip_retrieval_tpu.parallel.train import clip_contrastive_loss as jax_loss
from clip_retrieval_tpu_torch.models.configs import TEST_TINY
from clip_retrieval_tpu_torch.models.loaders import from_jax_params
from clip_retrieval_tpu_torch.ops import attention, flash
from clip_retrieval_tpu_torch.parallel import train as ptrain

from tests.test_parallel.subproc import run_in_subprocess

ROOT = Path(__file__).resolve().parents[1]
BATCH = 8
LR = 1e-3
LOSS_RTOL = 2e-4
MIN_COS = 0.9999
ZERO_GRAD_ATOL = 1e-5
RANK_TIMEOUT_S = 240

RANK_CODE = """
import datetime, json, sys
import numpy as np, torch
import torch.distributed as dist
from clip_retrieval_tpu_torch.models.configs import TEST_TINY
from clip_retrieval_tpu_torch.parallel.train import make_train_step

rank, dp, tp, root, steps = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], int(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + root + "/store", rank=rank, world_size=dp * tp,
                        timeout=datetime.timedelta(seconds=120))
data = np.load(root + "/inputs.npz")
tree = {}
for key in data.files:
    if key.startswith("params/"):
        node = tree
        *path, leaf = key.split("/")[1:]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = data[key]
zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in t.items()}
init_fn, step = make_train_step(TEST_TINY, learning_rate=%r, dp=dp, tp=tp, device="cpu")
params, opt = init_fn(jax_state={"params": tree, "mu": zeros(tree), "nu": zeros(tree), "count": 0})
b = data["images"].shape[0] // dp
rows = slice(rank // tp * b, (rank // tp + 1) * b)
losses = []
for _ in range(steps):
    images, tokens = torch.from_numpy(data["images"][rows]), torch.from_numpy(data["tokens"][rows])
    params, opt, loss = step(params, opt, images, tokens)
    losses.append(float(loss))
np.savez(root + f"/rank{rank}.npz", **{n: p.grad.numpy() for n, p in params.named_parameters()})
json.dump(losses, open(root + f"/rank{rank}.json", "w"))
dist.destroy_process_group()
""" % LR


def _flatten(tree, prefix: str) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v) for path, v in leaves}


def _unflatten(flat: dict, prefix: str) -> dict:
    tree = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (BATCH, TEST_TINY.image_size, TEST_TINY.image_size, 3)).astype(np.uint8)
    tokens = rng.integers(1, TEST_TINY.vocab_size - 2, (BATCH, TEST_TINY.context_length)).astype(np.int32)
    return images, tokens


@pytest.fixture(scope="module")
def jax_reference(batch):
    """JAX params (seed 0) and the loss and gradients of one step on them."""
    images, tokens = batch
    params = jclip.init_clip(JTINY, 0)

    def loss_fn(p):
        img, txt, scale = jclip.clip_forward(p, JTINY, jnp.asarray(images), jnp.asarray(tokens), attn_impl="xla")
        return jax_loss(img, txt, scale)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return _flatten(params, "params/"), float(loss), jax.tree.map(np.asarray, grads)


def _run_ranks(root: Path, dp: int, tp: int, steps: int) -> list:
    env = {**{k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(r), str(dp), str(tp), str(root), str(steps)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(dp * tp)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return [json.load(open(root / f"rank{r}.json")) for r in range(dp * tp)]


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    return float(a.ravel() @ b.ravel() / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_loss_and_gradients_match_jax(tmp_path, batch, jax_reference, dp, tp):
    flat_params, want_loss, jax_grads = jax_reference
    np.savez(tmp_path / "inputs.npz", images=batch[0], tokens=batch[1], **flat_params)
    losses = _run_ranks(tmp_path, dp, tp, steps=1)
    want = from_jax_params(jax_grads, TEST_TINY, device="cpu")
    for r in range(dp * tp):
        np.testing.assert_allclose(losses[r][0], want_loss, rtol=LOSS_RTOL)
        got = np.load(tmp_path / f"rank{r}.npz")
        full = dict(want.named_parameters())
        assert sorted(got.files) == sorted(full)
        for name, g in got.items():
            dim = ptrain.tp_dim(name)
            w = full[name].detach().numpy()
            if dim is not None and tp > 1:
                w = np.split(w, tp, axis=dim)[r % tp]
            assert g.shape == w.shape, name
            if np.linalg.norm(w) < 1e-6:
                assert np.abs(g).max() <= ZERO_GRAD_ATOL, name
            else:
                assert _cos(g, w) >= MIN_COS, (name, _cos(g, w))


def test_three_steps_from_carried_jax_state_track_jax(tmp_path, batch):
    """JAX takes one step (so that mu, nu and count are not trivial), saves
    its state and takes three more; the port takes the same three from the
    carried state."""
    images, tokens = batch
    np.savez(tmp_path / "batch.npz", images=images, tokens=tokens)
    out = run_in_subprocess(
        f"""
        import json, numpy as np, jax
        from jax.sharding import Mesh
        from clip_retrieval_tpu.models.configs import TEST_TINY
        from clip_retrieval_tpu.parallel.train import make_train_step

        data = np.load({str(tmp_path / "batch.npz")!r})
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
        with mesh:
            init_fn, step = make_train_step(TEST_TINY, mesh, learning_rate={LR})
            params, opt = init_fn(0)
            params, opt, _ = step(params, opt, data["images"], data["tokens"])
            flat = {{}}
            for prefix, tree in (("params/", params), ("mu/", opt[0].mu), ("nu/", opt[0].nu)):
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    flat[prefix + "/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(v)
            np.savez({str(tmp_path / "state.npz")!r}, count=np.asarray(opt[0].count), **flat)
            losses = []
            for _ in range(3):
                params, opt, loss = step(params, opt, data["images"], data["tokens"])
                losses.append(float(loss))
        print("LOSSES", json.dumps(losses))
        """
    )
    want = json.loads(out.split("LOSSES", 1)[1].strip().splitlines()[0])
    state = dict(np.load(tmp_path / "state.npz"))
    jax_state = {name: _unflatten(state, name + "/") for name in ("params", "mu", "nu")}
    jax_state["count"] = state["count"]
    init_fn, step = ptrain.make_train_step(TEST_TINY, learning_rate=LR, device="cpu")
    params, opt = init_fn(jax_state=jax_state)
    p0 = next(iter(opt.state.values()))
    assert float(p0["step"]) == 1.0 and float(p0["exp_avg_sq"].abs().sum()) > 0
    got = []
    for _ in range(3):
        params, opt, loss = step(params, opt, torch.from_numpy(images), torch.from_numpy(tokens))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]


def test_adamw_equals_optax_adamw_on_one_leaf():
    """eps after the square root, bias correction, decoupled decay on the
    leaf, five steps of varying gradients: equal up to f32 roundings taken
    in another order (a few per step on values of order 1)."""
    rng = np.random.default_rng(4)
    w0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) * s for s in (1.0, 0.1, 3.0, 1e-3, 0.5)]
    tx = optax.adamw(1e-2, weight_decay=0.05)
    jw = jnp.asarray(w0)
    st = tx.init(jw)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = torch.optim.AdamW([tw], lr=1e-2, weight_decay=0.05)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jw)
        jw = optax.apply_updates(jw, upd)
        tw.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)


def test_contrastive_loss_matches_jax():
    rng = np.random.default_rng(9)
    img, txt = rng.normal(size=(2, 6, 8)).astype(np.float32)
    got = ptrain.clip_contrastive_loss(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(14.3))
    np.testing.assert_allclose(float(got), float(jax_loss(jnp.asarray(img), jnp.asarray(txt), 14.3)), rtol=1e-6)
    feats = torch.eye(4, 8)
    assert float(ptrain.clip_contrastive_loss(feats, feats, torch.tensor(100.0))) < 0.01


def test_k1_refuses_inputs_that_require_grad():
    q, k, v = (torch.randn(2, 5, 8, requires_grad=True) for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        flash.flash_attention_packed(q, k, v, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        flash.flash_attention(q.reshape(2, 1, 5, 8), k.reshape(2, 1, 5, 8), v.reshape(2, 1, 5, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        attention.sdpa_packed(q, k, v, 2)  # impl 'auto' is the kernel
    with torch.no_grad():
        want = flash.flash_attention_packed(q, k, v, 2, causal=True)
    got = attention.sdpa_packed(q, k, v, 2, causal=True, impl="xla")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    got.sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in (q, k, v))


def test_clip_forward_matches_jax_and_trains_only_on_the_plain_route(batch):
    images, tokens = batch
    params = jclip.init_clip(JTINY, 3)
    jimg, jtxt, jscale = jclip.clip_forward(params, JTINY, jnp.asarray(images), jnp.asarray(tokens),
                                            attn_impl="xla")
    model = ptrain.shard_model(from_jax_params(jax.tree.map(np.asarray, params), TEST_TINY, device="cpu"), 1, 0)
    with pytest.raises(RuntimeError, match="no backward"):
        from clip_retrieval_tpu_torch.models.clip import clip_forward

        clip_forward(model, torch.from_numpy(images), torch.from_numpy(tokens))
    img, txt, scale = clip_forward(model, torch.from_numpy(images), torch.from_numpy(tokens), attn_impl="xla")
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), atol=2e-5)
    np.testing.assert_allclose(txt.detach().numpy(), np.asarray(jtxt), atol=2e-5)
    np.testing.assert_allclose(float(scale.detach()), float(jscale), rtol=1e-6)


def test_train_step_rejects_splits_jax_would_reject():
    with pytest.raises(ValueError, match="does not divide"):
        ptrain.make_train_step(TEST_TINY, tp=3, device="cpu")  # 4 heads
    with pytest.raises(RuntimeError, match="needs torch.distributed"):
        ptrain.make_train_step(TEST_TINY, dp=2, device="cpu")


def test_tp_rules_follow_jax_param_pspec():
    """The split dim of every parameter name agrees with JAX `param_pspec`
    on the same leaf (one axis less: the port keeps no layer axis)."""
    from jax.sharding import PartitionSpec as P

    from clip_retrieval_tpu.parallel.train import param_pspec

    params = jclip.init_clip(JTINY, 0)
    specs = {"/".join(str(getattr(k, "key", k)) for k in path): param_pspec(path, leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    model = from_jax_params(jax.tree.map(np.asarray, params), TEST_TINY, device="cpu")
    seen = 0
    for name, _ in model.named_parameters():
        parts = name.split(".")
        in_blocks = "blocks" in parts
        key = "/".join(p for i, p in enumerate(parts) if not (in_blocks and i == parts.index("blocks") + 1))
        spec = tuple(specs[key])
        want = None
        if "tp" in spec:
            want = spec.index("tp") - (1 if in_blocks else 0)
        assert ptrain.tp_dim(name) == want, (name, spec)
        seen += want is not None
    assert seen == 2 * 2 * 10 + 1  # 2 towers x 2 layers x 10 split leaves + token_emb
    assert specs["text/token_emb"] == P("tp", None)
