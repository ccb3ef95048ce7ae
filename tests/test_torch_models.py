"""The port's LM stack (``repro_torch.models``, ``configs``, ``data``,
``serve``, ``launch``) against the JAX reference on the CPU.

Weights come from the reference's ``init`` and are carried across by
``load_reference_params``; the zero-initialised norm scales and biases
are first set to seeded noise, so that carrying them matters.  Inputs
come from numpy seeds.  Tolerances (max-abs, logits of magnitude up to
~3):

- float32: 1e-4 for a forward or a decode step (the products and sums
  run in another order; measured ~2e-6), 1e-5 for one layer;
- bfloat16: 2^-4, four bfloat16 steps at magnitudes in [2, 4) (every
  layer rounds its outputs to bfloat16, and one rounding that lands the
  other way moves the rest; measured up to 2^-5.2).
"""

from dataclasses import asdict, replace

import numpy as np
import pytest

from _torch import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as JR
from repro.configs import steps as jsteps
from repro.data import synth as jsynth
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import transformer as jt

from repro_torch.configs import registry as R
from repro_torch.configs import steps
from repro_torch.data import synth
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models.transformer import (Transformer,
                                            TransformerConfig,
                                            load_reference_params)
from repro_torch.serve import serving

LM_ARCHS = ["glm4-9b", "gemma-7b", "qwen2-7b"]
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -4}


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _err(got, want) -> float:
    return float(np.abs(_np32(got) - _np32(want)).max())


def _t(a):
    """A numpy array (bfloat16 too) as a torch tensor, bits unchanged."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _ref_tree(cfg, seed=0):
    """The reference's params as numpy, norm scales and biases set to
    seeded noise (they are zeros at init)."""
    tree = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 100)

    def noisy(path, a):
        name = jax.tree_util.keystr(path)
        if "scale" in name or "'b" in name:
            return (rng.normal(size=a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(noisy, tree)


def _gen():
    return torch.Generator("cpu").manual_seed(0)


def cfg_port(cfg):
    """The reference's TransformerConfig as the port's."""
    return TransformerConfig(**asdict(cfg))


def _pair(cfg, seed=0):
    """(reference params, the port's model with the same weights)."""
    tree = _ref_tree(cfg, seed)
    model = Transformer(cfg_port(cfg), device="cpu", generator=_gen())
    load_reference_params(model, tree)
    return jax.tree.map(jnp.asarray, tree), model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


# ---------------------------------------------------------------- registry

def test_registry_matches_the_reference_lm_entries():
    assert R.all_archs() == sorted(
        a for a in JR.all_archs() if JR.get(a).family == "lm")
    for arch in R.all_archs():
        e, je = R.get(arch), JR.get(arch)
        assert (e.family, e.shapes, e.source) == (je.family, je.shapes,
                                                  je.source)
        assert asdict(e.full) == asdict(je.full)
        assert asdict(e.smoke) == asdict(je.smoke)
        for smoke in (True, False):
            assert R.shape_defs(arch, smoke) == JR.shape_defs(arch, smoke)
            for shape in e.shapes:
                got = R.input_specs(arch, shape, smoke)
                want = JR.input_specs(arch, shape, smoke)
                flat_g = jax.tree.leaves(got)
                flat_w = jax.tree.leaves(want)
                assert [tuple(t.shape) for t in flat_g] == \
                    [tuple(w.shape) for w in flat_w]
                assert [str(t.dtype).split(".")[-1] for t in flat_g] == \
                    [str(w.dtype) for w in flat_w]
                assert all(t.device.type == "meta" for t in flat_g)
    assert steps.all_cells() == [c for c in jsteps.all_cells()
                                 if JR.get(c[0]).family == "lm"]
    full = R.get("qwen2-7b").full
    assert full.n_params == JR.get("qwen2-7b").full.n_params
    assert 7.0e9 < full.n_params < 8.0e9


def test_per_arch_config_modules():
    from repro_torch.configs import gemma_7b, glm4_9b, qwen2_7b

    for mod, arch in ((glm4_9b, "glm4-9b"), (gemma_7b, "gemma-7b"),
                      (qwen2_7b, "qwen2-7b")):
        assert mod.FULL == R.get(arch).full and mod.SMOKE == R.get(arch).smoke
        assert mod.SHAPES == R.LM_SHAPES


def test_build_cell_kinds():
    cell = steps.build_cell("qwen2-7b", "decode_32k", smoke=True,
                            overrides={"n_layers": 1, "no_such_field": 3})
    assert cell.kind == "decode" and cell.model_cfg.n_layers == 1
    assert steps.cache_len(R.input_specs("qwen2-7b", "decode_32k", True)) \
        == 128
    with pytest.raises(NotImplementedError, match="slice 7b"):
        steps.build_cell("qwen2-7b", "train_4k", smoke=True)
    with pytest.raises(KeyError):
        steps.build_cell("deepfm", "serve_p99")


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_make_batch_is_the_references(arch, shape):
    got = synth.make_batch(arch, shape, smoke=True, seed=3)
    want = jsynth.make_batch(arch, shape, smoke=True, seed=3)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.numpy().dtype == w.dtype
        assert g.numpy().tobytes() == w.tobytes()


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_apply_rope(fraction, dt):
    x = np.random.default_rng(0).normal(size=(2, 3, 9, 14)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) * 7
    want = JL.apply_rope(jnp.asarray(x, getattr(jnp, dt)), jnp.asarray(pos),
                         1e6, fraction)
    got = L.apply_rope(torch.from_numpy(x).to(getattr(torch, dt)),
                       torch.from_numpy(pos), 1e6, fraction)
    assert got.dtype == getattr(torch, dt)
    # float32: cos/sin of angles up to 56 rad differ in the last ulps
    assert _err(got, want) <= (1e-5 if dt == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rmsnorm_and_dense(dt):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    scale = (rng.normal(size=32) * 0.1).astype(np.float32)
    w = (rng.normal(size=(32, 24)) * 0.2).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dt))
    tx = torch.from_numpy(x).to(getattr(torch, dt))
    for plus_one in (True, False):
        want = JL.rmsnorm(jx, {"scale": jnp.asarray(scale)},
                          plus_one=plus_one)
        got = L.rmsnorm(tx, {"scale": torch.from_numpy(scale)},
                        plus_one=plus_one)
        assert got.dtype == tx.dtype
        assert _err(got, want) <= (1e-5 if dt == "float32" else 2.0 ** -6)
    # the weight and bias are cast to the activation's dtype first
    want = JL.dense(jx, jnp.asarray(w), jnp.asarray(b))
    got = L.dense(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == tx.dtype
    assert _err(got, want) <= (1e-5 if dt == "float32" else 2.0 ** -5)


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_glu_ffn(act):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 16)).astype(np.float32)
    p = {k: (rng.normal(size=s) * 0.3).astype(np.float32)
         for k, s in (("wi", (16, 40)), ("wg", (16, 40)), ("wo", (40, 16)))}
    want = JL.glu_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                      act)
    got = L.glu_ffn(torch.from_numpy(x),
                    {k: torch.from_numpy(v) for k, v in p.items()}, act)
    assert _err(got, want) <= 1e-5
    with pytest.raises(ValueError):
        L.glu_ffn(torch.from_numpy(x),
                  {k: torch.from_numpy(v) for k, v in p.items()}, "relu")


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_attention_layer(with_cache, fraction):
    rng = np.random.default_rng(3)
    d_model, n_heads, n_kv, hd = 48, 6, 2, 8
    p = jax.tree.map(np.asarray, JL.init_attention(
        jax.random.PRNGKey(0), d_model, n_heads, n_kv, hd, True,
        jnp.float32))
    for k in ("bq", "bk", "bv"):
        p[k] = (rng.normal(size=p[k].shape) * 0.1).astype(np.float32)
    s = 1 if with_cache else 11
    x = rng.normal(size=(2, s, d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32) + (20 if with_cache else 0)
    cache = None
    if with_cache:
        cache = tuple(rng.normal(size=(2, n_kv, 20, hd)).astype(np.float32)
                      for _ in range(2))
    want, wcache = JL.attention(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, n_heads,
        n_kv, hd, jnp.asarray(pos), 1e4, fraction,
        kv_cache=None if cache is None else tuple(map(jnp.asarray, cache)))
    got, gcache = L.attention(
        torch.from_numpy(x), {k: torch.tensor(v) for k, v in p.items()},
        n_heads, n_kv, hd, torch.from_numpy(pos), 1e4, fraction,
        kv_cache=None if cache is None else tuple(map(torch.from_numpy,
                                                      cache)))
    assert _err(got, want) <= 1e-5
    if with_cache:
        assert gcache[0].shape == (2, n_kv, 21, hd)
        for g, w in zip(gcache, wcache):
            assert _err(g, w) <= 1e-5
    else:
        assert gcache is None and wcache is None


# ----------------------------------------------------------------- forward

@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("force", [None, "pallas"])
def test_forward_matches_reference(arch, dt, force, monkeypatch):
    """The port's forward against the reference's, on its default CPU
    path and with the Pallas kernel forced (interpret mode)."""
    monkeypatch.setattr(jops, "FORCE", force)
    cfg = replace(JR.get(arch).smoke, dtype=dt)
    params, model = _pair(cfg)
    toks = _tokens(cfg, 2, 16)
    want = jt.forward(params, jnp.asarray(toks), cfg)
    with torch.inference_mode():
        got = model(torch.from_numpy(toks))
    assert got.dtype == getattr(torch, dt)
    assert tuple(got.shape) == (2, 16, cfg.vocab)
    assert _err(got, want) <= TOL[dt]


@pytest.mark.parametrize("scan_layers", [True, False])
def test_forward_matches_reference_scanned_or_unrolled(scan_layers):
    """Twin of ``test_scan_vs_unrolled_equivalence``: the port's layer loop
    against the reference's scan and its unrolled layers."""
    cfg = replace(JR.get("qwen2-7b").smoke, dtype="float32",
                  scan_layers=scan_layers)
    params, model = _pair(cfg, seed=1)
    toks = _tokens(cfg, 2, 16, seed=1)
    want = jt.forward(params, jnp.asarray(toks), cfg)
    with torch.inference_mode():
        got = model(torch.from_numpy(toks))
    assert _err(got, want) <= TOL["float32"]


def test_lm_forward_shapes():
    """Twin of the reference's ``test_lm_forward_shapes``, also holding
    the logits against the reference's on the same weights."""
    cell = steps.build_cell("qwen2-7b", "prefill_32k", smoke=True)
    jcell = jsteps.build_cell("qwen2-7b", "prefill_32k", smoke=True)
    batch = synth.make_batch("qwen2-7b", "prefill_32k", smoke=True)
    params, model = _pair(jcell.model_cfg, seed=1)
    with torch.inference_mode():
        logits = cell.fn(model, batch)
    b, s = batch["tokens"].shape
    assert logits.shape == (b, s, cell.model_cfg.vocab)
    want = jax.jit(jcell.fn)(params,
                             {"tokens": jnp.asarray(batch["tokens"].numpy())})
    assert _err(logits, want) <= TOL["bfloat16"]
    prefill = serving.make_prefill("lm", cell.model_cfg)
    with torch.inference_mode():
        assert torch.equal(prefill(model, batch["tokens"]), logits)


# ------------------------------------------------------------------ decode

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_shapes_and_finiteness(arch):
    """Twin of the reference's dense cases, also holding the logits and the
    updated cache against the reference's ``decode_step``."""
    cell = steps.build_cell(arch, "decode_32k", smoke=True)
    jcell = jsteps.build_cell(arch, "decode_32k", smoke=True)
    batch = synth.make_batch(arch, "decode_32k", smoke=True)
    params, model = _pair(jcell.model_cfg)
    cache = {k: v.to(torch.bfloat16) for k, v in batch["cache"].items()}
    jcache = {k: jnp.asarray(v.numpy(), jnp.bfloat16)
              for k, v in batch["cache"].items()}
    with torch.inference_mode():
        logits, new_cache = cell.fn(model, batch["token"],
                                    {k: v.clone() for k, v in cache.items()})
    assert logits.shape == (batch["token"].shape[0], cell.model_cfg.vocab)
    assert torch.isfinite(logits.float()).all()
    assert set(new_cache) == {"k", "v"}
    want, wcache = jax.jit(jcell.fn)(params,
                                     jnp.asarray(batch["token"].numpy()),
                                     jcache)
    assert _err(logits, want) <= TOL["bfloat16"]
    pos = steps.cache_len(R.input_specs(arch, "decode_32k", True)) - 1
    for k in ("k", "v"):
        g, w = new_cache[k], _t(np.asarray(wcache[k]))
        assert g.dtype == w.dtype == torch.bfloat16
        # untouched positions keep their bits; the new one is close
        assert torch.equal(g[..., :pos, :], w[..., :pos, :])
        assert torch.equal(g[..., :pos, :], cache[k][..., :pos, :])
        assert _err(g[..., pos, :], w[..., pos, :]) <= TOL["bfloat16"]


@pytest.mark.parametrize("pos", [5, 15, 16, 40])
def test_decode_step_clamps_the_write_as_jax(pos):
    """``decode_step`` in float32 against the reference, the last position
    and past the cache's end: the write lands at ``min(pos, S - 1)``, as
    ``dynamic_update_slice`` clamps, while the mask and RoPE read ``pos``."""
    cfg = replace(JR.get("glm4-9b").smoke, dtype="float32")
    params, model = _pair(cfg, seed=2)
    rng = np.random.default_rng(pos)
    shape = (cfg.n_layers, 3, cfg.n_kv, 16, cfg.head_dim)
    k = (rng.normal(size=shape) * 0.5).astype(np.float32)
    v = (rng.normal(size=shape) * 0.5).astype(np.float32)
    token = rng.integers(0, cfg.vocab, 3).astype(np.int32)
    want, wcache = jt.decode_step(
        params, jnp.asarray(token), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(pos, jnp.int32), cfg)
    with torch.inference_mode():
        got, gcache = model.decode_step(
            torch.from_numpy(token),
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())},
            pos)
    assert _err(got, want) <= TOL["float32"]
    at = min(pos, 15)
    for name, orig in (("k", k), ("v", v)):
        g, w = gcache[name].numpy(), np.asarray(wcache[name])
        np.testing.assert_array_equal(np.delete(g, at, axis=3),
                                      np.delete(orig, at, axis=3))
        assert np.abs(g - w).max() <= 1e-5
        assert np.abs(g[..., at, :] - orig[..., at, :]).max() > 0


# ------------------------------------------------------- weights carried in

def test_bfloat16_weights_round_trip():
    """Reference bfloat16 params reach the module bit for bit (numpy's
    bfloat16 through a uint16 view), norm scales stay float32, and a tree
    that does not fit the model is refused."""
    cfg = JR.get("gemma-7b").smoke
    tree = _ref_tree(cfg)
    model = load_reference_params(
        Transformer(cfg_port(cfg), device="cpu", generator=_gen()), tree)
    named = dict(model.named_parameters())
    assert "unembed" not in named  # tied
    assert named["layers.1.attn.wq"].dtype == torch.bfloat16
    assert named["layers.0.attn_norm.scale"].dtype == torch.float32
    for name, a in (("embed", tree["embed"]),
                    ("layers.1.attn.wq", tree["layers"]["attn"]["wq"][1]),
                    ("layers.0.ffn.wo", tree["layers"]["ffn"]["wo"][0]),
                    ("final_norm.scale", tree["final_norm"]["scale"])):
        got = named[name].detach()
        if got.dtype == torch.bfloat16:
            got = got.view(torch.uint16)
            a = np.asarray(a).view(np.uint16)
        np.testing.assert_array_equal(got.numpy(), np.asarray(a))
    other = _ref_tree(JR.get("qwen2-7b").smoke)
    with pytest.raises(ValueError, match="param trees differ|reference"):
        load_reference_params(
            Transformer(cfg_port(cfg), device="cpu", generator=_gen()), other)


def test_embedding_scale_rounds_to_the_activation_dtype():
    """Gemma's sqrt(d_model) is rounded to bfloat16 first, as the
    reference's ``jnp.asarray(d ** 0.5, x.dtype)``: 55.5 for 3072."""
    cfg = replace(cfg_port(JR.get("gemma-7b").smoke), d_model=3072,
                  n_layers=0, vocab=4)
    model = Transformer(cfg, device="cpu", generator=_gen())
    with torch.no_grad():
        model.embed.fill_(1.0)
    assert model._embed(torch.tensor([[0]])).flatten()[0].item() == 55.5


# ------------------------------------------------------ serving entry points

def test_entry_points_default_to_the_card():
    cfg = cfg_port(JR.get("qwen2-7b").smoke)
    if torch.cuda.is_available():
        gen = torch.Generator("cuda").manual_seed(0)
        assert Transformer(cfg, generator=gen).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Transformer(cfg, generator=_gen())
    with pytest.raises(ValueError, match="generator"):
        Transformer(cfg, device="meta", generator=torch.Generator("cpu"))
    with pytest.raises(NotImplementedError, match="slice 7b"):
        serving.make_decode_step("moe", cfg)
    assert serving.make_decode_step("lm", cfg) is Transformer.decode_step


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_launcher_serves_on_the_cpu(shape, capsys):
    before = dict(ops.LAUNCHES)
    launch_serve.main(["--arch", "qwen2-7b", "--shape", shape, "--device",
                       "cpu", "--tokens", "2"])
    out = capsys.readouterr().out
    assert "on the CPU" in out
    assert ("batch 4" in out) if shape == "decode_32k" else \
        "(2, 128, 256)" in out
    assert ops.LAUNCHES == before
