"""rpnet_tpu_torch's opt-in correlation forwards vs the JAX package.

The JAX package selects four more Pallas forwards of the local correlation
with ``RPNET_CORR_IMPL`` (``pallas_mxu``, ``csub``, ``rot``),
``RPNET_ROT_EXTRACT=pdot`` and ``RPNET_ROT_PACK=1``; the port resolves the
same variables (``ops.correlation.correlation_route``) to its own kernels.
On the CPU the port's wrappers run the plain versions, which are held here:

  * kernel level — each plain version against the Pallas function it
    replaces, in interpret mode, at the JAX package's own test shapes
    (``tests/test_ops.py``);
  * route level — the port's CRE and the JAX CRE under every row of the
    switch table, eval and training, must pick the same forward (the JAX
    kernels are replaced by recorders; the JAX CRE is told it runs on a TPU,
    where its switches act);
  * slice level — the port's CRE with the JAX weights against the JAX CRE
    (``use_pallas=True``) under each switch, eval mode;
  * training — one SGD step under ``pallas_mxu`` and under ``csub`` against
    the JAX trainer (whose correlation is the XLA formulation on the CPU).

The Hopper kernels run only on the card; ``chip_smoke.py`` holds them
against these plain versions there.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.models.cre import ContextCorrelationEncoder as JaxCRE
from rpnet_tpu.models.rpnet import RPNet as JaxRPNet
from rpnet_tpu.ops.pallas import correlation as pc
from rpnet_tpu_torch.models import cre as port_cre
from rpnet_tpu_torch.models.cre import ContextCorrelationEncoder
from rpnet_tpu_torch.models.rpnet import RPNet
from rpnet_tpu_torch.ops import correlation as tc
from rpnet_tpu_torch.train.convert import state_dict_from_jax

from test_torch_models import jax_rpnet
from test_torch_train import _config, param_change_close, run_both, smooth_batch
from test_torch_train import weights  # noqa: F401 — module fixture

ENV = ("RPNET_CORR_IMPL", "RPNET_ROT_EXTRACT", "RPNET_ROT_PACK")


def _inputs(seed, shape, scale=None):
    rng = np.random.RandomState(seed)
    a, b = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    if scale is not None:            # per-slice magnitudes
        a *= scale[:, None, None, None]
        b *= scale[:, None, None, None]
    return a, b


def _bf16_pair(f1, f2):
    """The same bf16 values as a JAX and a torch array pair."""
    j = [jnp.asarray(x).astype(jnp.bfloat16) for x in (f1, f2)]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in j]
    return j, t


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _within_one_ulp(a, b):
    """|a − b| ≤ one bf16 ulp of the larger magnitude, plus 1e-5 for values
    near zero, where f32 sums in another order part by more than their ulp."""
    return np.abs(a - b) <= _bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + 1e-5


# ----------------------------------------------------------- kernel level

def test_band_plain_matches_pallas_mxu():
    """Row 5: ``_corr_mxu_kernel`` in interpret mode, f32, 2×16×16×64, r=3
    (atol 1e-5: f32 sums over C=64 in another order)."""
    f1, f2 = _inputs(0, (2, 16, 16, 64))
    ref = np.asarray(pc.local_correlation_pallas_mxu(jnp.asarray(f1), jnp.asarray(f2), 3,
                                                     h_tile=8, interpret=True))
    out = tc.local_correlation_band(torch.from_numpy(f1), torch.from_numpy(f2), 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_csub_plain_matches_pallas_csub(dtype):
    """Row 6: ``_corr_csub_kernel`` in interpret mode, 2×16×16×64, r=3; the
    port's plain version takes the kernel's (B, H, C, W) layout and gives
    (B, H, W, d²). f32: atol 1e-5 (sums in another order). bf16: bit for
    bit. The JAX kernel writes ``(fm1 * sub).astype(f32)`` with bf16
    operands; in interpret mode its result is the f32 sum of the exact
    products, rounded once, which is what the port computes."""
    f1, f2 = _inputs(1, (2, 16, 16, 64))
    if dtype == "bfloat16":
        (j1, j2), (p1, p2) = _bf16_pair(f1, f2)
    else:
        j1, j2, p1, p2 = jnp.asarray(f1), jnp.asarray(f2), torch.from_numpy(f1), torch.from_numpy(f2)
    ref = pc.local_correlation_pallas_csub(j1, j2, 3, h_tile=8, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    t1, t2 = (x.transpose(2, 3).contiguous() for x in (p1, p2))
    out = tc.local_correlation_csub(t1, t2, 3)
    assert out.shape == (2, 16, 16, 49) and out.dtype == t1.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(out.float().numpy(), ref)
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("dtype,partner", [("float32", 1.0), ("bfloat16", 1.0),
                                           ("float32", 300.0)])
def test_pack_plain_matches_rot2_kernel(dtype, partner):
    """Row 3: ``_corr_rot2_kernel`` (the packed impl, interpret mode) at
    4×16×64×32, r=5, through the port's packed plain version on the packed
    layout. f32: atol 1e-5 times the square of the slice's scale, where the
    second slice of each pair is ``partner`` times larger (f32 sums in
    another order; a query reading its partner's columns would be off by
    about ``partner``). bf16: within one bf16 ulp (the f32 sums differ only
    in order; 1e-5 near zero)."""
    r = 5
    scale = np.array([1.0, partner, 1.0, partner])
    f1, f2 = _inputs(2, (4, 16, 64, 32), scale=scale)
    if dtype == "bfloat16":
        (j1, j2), (t1, t2) = _bf16_pair(f1, f2)
    else:
        j1, j2, t1, t2 = jnp.asarray(f1), jnp.asarray(f2), torch.from_numpy(f1), torch.from_numpy(f2)
    out128 = pc._local_correlation_pallas_rot_impl(j1, j2, r, h_tile=16, interpret=True,
                                                    pack=True)
    ref = np.asarray(pc.rot_to_quirk(out128, r).astype(jnp.float32))
    packed = tc.local_correlation_packed(tc.pack_pairs(t1), tc.pack_pairs(t2), r, 64)
    assert packed.shape == (2, 16, 128, 121)
    out = tc.unpack_pairs(packed).float().numpy()
    if dtype == "bfloat16":
        assert _within_one_ulp(out, ref).all()
    else:
        err = np.abs(out - ref) / (scale ** 2)[:, None, None, None]
        assert err.max() <= 1e-5, err.max()
    # the packed function is the unpacked one: no query sees its partner
    np.testing.assert_array_equal(out, tc.local_correlation_plain(t1, t2, r).float().numpy())


@pytest.mark.parametrize("C", [64, 48])
def test_pdot_plain_matches_rot_kernel_pdot(C):
    """Row 2: ``_corr_rot_kernel(pdot=True)`` in interpret mode, bf16,
    2×16×16×C, r=2. Values bf16(f32(bf16(S))·f32(bf16(scale))): equal, or one
    bf16 ulp of S, carried through the scale and the second rounding, where
    the two f32 sums S straddle a rounding boundary (counted, < 1%; 1e-5 near
    zero). C=64 (scale 2⁻³) equals the select value bit for bit; C=48 (scale
    not a power of two) does not, and the port reproduces that."""
    r = 2
    f1, f2 = _inputs(3 + C, (2, 16, 16, C))
    (j1, j2), (t1, t2) = _bf16_pair(f1, f2)
    out128 = pc._local_correlation_pallas_rot_impl(j1, j2, r, h_tile=8, interpret=True,
                                                    pdot=True)
    ref = np.asarray(pc.rot_to_quirk(out128, r).astype(jnp.float32))
    out = tc.local_correlation_pdot(t1, t2, r)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    scale = float(torch.tensor(tc.correlation_scale(C), dtype=torch.bfloat16))
    s_ulp = _bf16_ulp(tc._corr_sums(t1, t2, r).numpy()) * scale
    tol = s_ulp + _bf16_ulp(np.maximum(np.abs(out), np.abs(ref))) + 1e-5
    assert (np.abs(out - ref) <= tol).all()
    assert np.mean(out != ref) < 0.01, np.mean(out != ref)
    select = tc.local_correlation_plain(t1, t2, r).float().numpy()
    if C == 64:
        np.testing.assert_array_equal(out, select)
    else:
        assert np.mean(out != select) > 0.05


def test_wrappers_send_cpu_tensors_to_plain_versions():
    f1, f2 = _inputs(4, (2, 6, 8, 16))
    a, b = torch.from_numpy(f1), torch.from_numpy(f2)
    for fn in (tc.local_correlation_band, tc.local_correlation_pdot,
               tc.local_correlation_packed, tc.local_correlation_csub):
        fn.launches = 0
    np.testing.assert_array_equal(tc.local_correlation_band(a, b, 2).numpy(),
                                  tc.local_correlation_plain(a, b, 2).numpy())
    np.testing.assert_array_equal(tc.local_correlation_pack(a, b, 2).numpy(),
                                  tc.local_correlation_plain(a, b, 2).numpy())
    # a (B, H, C, W) tensor sums its channels in another order
    np.testing.assert_allclose(tc.FORWARDS["csub"](a, b, 2).numpy(),
                               tc.local_correlation_plain(a, b, 2).numpy(), atol=1e-6)
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    np.testing.assert_array_equal(tc.local_correlation_pdot(ab, bb, 2).float().numpy(),
                                  tc.local_correlation_pdot_plain(ab, bb, 2).float().numpy())
    with pytest.raises(ValueError):
        tc.local_correlation_pdot(a, b, 2)      # the pdot contract is bf16 only
    assert all(fn.launches == 0 for fn in (tc.local_correlation_band, tc.local_correlation_pdot,
                                           tc.local_correlation_packed, tc.local_correlation_csub))


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor that is not on the CPU never takes a plain version."""
    m = torch.empty((2, 4, 8, 16), device="meta")
    for fn in (tc.local_correlation_band, tc.local_correlation_csub):
        with pytest.raises(ValueError):
            fn(m, m, 1)
    with pytest.raises(ValueError):
        tc.local_correlation_pdot(m.to(torch.bfloat16), m.to(torch.bfloat16), 1)
    with pytest.raises(ValueError):
        tc.local_correlation_packed(m, m, 1, 4)


# ------------------------------------------------------------ route level

# (mode, environment, (B, h, w), dtype, route): every row of the switch table
ROUTES = [
    ("eval", {}, (2, 4, 64), "float32", "select"),
    ("eval", {}, (2, 4, 128), "float32", "select"),                # W+2r > 128
    ("eval", {"RPNET_CORR_IMPL": "rot"}, (2, 4, 64), "float32", "select"),
    ("eval", {"RPNET_CORR_IMPL": "pallas"}, (2, 4, 64), "float32", "select"),
    ("eval", {"RPNET_ROT_PACK": "1"}, (2, 4, 64), "bfloat16", "pack"),
    ("eval", {"RPNET_CORR_IMPL": "rot", "RPNET_ROT_PACK": "1"}, (2, 4, 64), "float32", "pack"),
    ("eval", {"RPNET_ROT_PACK": "1"}, (3, 4, 64), "float32", "select"),   # B odd
    ("eval", {"RPNET_ROT_PACK": "1"}, (2, 4, 32), "float32", "select"),   # 2W ≠ 128
    ("eval", {"RPNET_ROT_EXTRACT": "pdot"}, (2, 4, 16), "bfloat16", "pdot"),
    ("eval", {"RPNET_CORR_IMPL": "rot", "RPNET_ROT_EXTRACT": "pdot"}, (3, 4, 64), "bfloat16",
     "pdot"),
    ("eval", {"RPNET_ROT_EXTRACT": "pdot"}, (2, 4, 16), "float32", "select"),   # warns
    ("eval", {"RPNET_ROT_PACK": "1", "RPNET_ROT_EXTRACT": "pdot"}, (2, 4, 64), "bfloat16",
     "pack"),                                                                    # warns
    ("eval", {"RPNET_CORR_IMPL": "pallas_mxu"}, (2, 4, 16), "float32", "band"),
    ("eval", {"RPNET_CORR_IMPL": "csub"}, (2, 4, 16), "float32", "csub"),
    ("train", {}, (2, 4, 64), "float32", "select"),
    ("train", {"RPNET_CORR_IMPL": "pallas"}, (2, 4, 16), "float32", "select"),
    ("train", {"RPNET_CORR_IMPL": "pallas_mxu"}, (2, 4, 16), "float32", "band"),
    ("train", {"RPNET_CORR_IMPL": "csub"}, (2, 4, 16), "float32", "csub"),
    ("train", {"RPNET_ROT_PACK": "1"}, (2, 4, 64), "float32", "select"),
    ("train", {"RPNET_CORR_IMPL": "rot"}, (2, 4, 64), "float32", "select"),
    ("train", {"RPNET_CORR_IMPL": "rot", "RPNET_ROT_PACK": "1"}, (2, 4, 64), "float32", "pack"),
    ("train", {"RPNET_CORR_IMPL": "rot", "RPNET_ROT_EXTRACT": "pdot"}, (2, 4, 16), "bfloat16",
     "pdot"),
    ("train", {"RPNET_CORR_IMPL": "rot", "RPNET_ROT_EXTRACT": "pdot"}, (2, 4, 16), "float32",
     "select"),                                                                  # warns
]


def _jax_route(monkeypatch, mode, shape, dtype, r=1, C=16):
    """The forward the JAX CRE picks on a TPU: ``jax.default_backend`` reads
    "tpu"; the Pallas entry points record what they are asked for and return
    zeros (values are the kernel-level tests' business)."""
    seen = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")

    def rot_impl(fm1, fm2, r, **kw):
        seen.append("pack" if kw["pack"] else "pdot" if kw["pdot"] else "select")
        return jnp.zeros(fm1.shape[:3] + (128,), fm1.dtype)

    def trainable(r, interpret=False, forward="pallas"):
        def f(fm1, fm2):
            if forward == "rot":      # _rot_quirk: the dispatcher, then the permutation
                return pc.rot_to_quirk(pc.local_correlation_pallas_rot(fm1, fm2, r), r)
            seen.append({"pallas": "select", "pallas_mxu": "band", "csub": "csub"}[forward])
            return jnp.zeros(fm1.shape[:3] + ((2 * r + 1) ** 2,), fm1.dtype)
        return f

    def rot_vmappable(r, interpret=False, fm2_reversed=False):
        return lambda fm1, fm2: pc.local_correlation_pallas_rot(
            fm1, fm2, r, interpret=interpret, fm2_reversed=fm2_reversed)

    monkeypatch.setattr(pc, "_local_correlation_pallas_rot_impl", rot_impl)
    monkeypatch.setattr(pc, "pallas_correlation_trainable", trainable)
    monkeypatch.setattr(pc, "pallas_rot_vmappable", rot_vmappable)
    B, h, w = shape
    x = jnp.ones((B, h, w, C), jnp.dtype(dtype))
    cre = JaxCRE(radius=r, use_pallas=True)
    variables = jax.tree_util.tree_map(
        lambda a: a.astype(x.dtype),
        cre.init(jax.random.PRNGKey(0), x, x, train=False))
    seen.clear()
    cre.apply(variables, x, x, train=mode == "train", mutable=["batch_stats"])
    return seen


def _port_route(monkeypatch, mode, shape, dtype, r=1, C=16):
    seen = []
    real = port_cre.correlation_route

    def spy(fm1, radius, training):
        seen.append(real(fm1, radius, training))
        return seen[-1]

    monkeypatch.setattr(port_cre, "correlation_route", spy)
    B, h, w = shape
    x = torch.ones((B, h, w, C), dtype=getattr(torch, dtype))
    cre = ContextCorrelationEncoder(C, r).to(x.dtype)
    cre.train(mode == "train")
    with torch.no_grad():
        cre(x, x)
    return seen


@pytest.mark.parametrize("mode,env,shape,dtype,route", ROUTES,
                         ids=[f"{m}-{'+'.join(f'{k[6:]}={v}' for k, v in e.items()) or 'unset'}"
                              f"-{s[0]}x{s[2]}-{d}" for m, e, s, d, _ in ROUTES])
def test_route_matches_jax_cre(monkeypatch, mode, env, shape, dtype, route):
    """The port's CRE resolves the environment to the forward the JAX CRE
    runs on a TPU, per call, in eval (``self.training`` False) and training."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_seen = _jax_route(monkeypatch, mode, shape, dtype)
        port_seen = _port_route(monkeypatch, mode, shape, dtype)
    assert jax_seen == port_seen == [route]


def test_route_is_resolved_per_call_and_warns_once(monkeypatch):
    """Toggling a variable between calls switches the forward; pdot set but
    shadowed warns once per reason, as ``_warn_pdot_ignored`` does."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    x = torch.zeros((2, 4, 64, 16))
    assert tc.correlation_route(x, 2, False) == "select"
    monkeypatch.setenv("RPNET_ROT_PACK", "1")
    assert tc.correlation_route(x, 2, False) == "pack"
    monkeypatch.setenv("RPNET_ROT_EXTRACT", "pdot")
    tc._warn_pdot_ignored.cache_clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(3):
            assert tc.correlation_route(x, 2, False) == "pack"
    assert len([m for m in w if "pdot" in str(m.message)]) == 1


@pytest.mark.parametrize("impl", ["xla", "mxu", "fake", "bogus"])
def test_unknown_corr_impl_raises(monkeypatch, impl):
    """The JAX package's XLA formulations and timing stub are not carried."""
    monkeypatch.setenv("RPNET_CORR_IMPL", impl)
    with pytest.raises(ValueError, match="pallas_mxu"):
        tc.correlation_route(torch.zeros((2, 4, 16, 16)), 2, False)


def test_rot_raises_where_the_rotate_variant_cannot_run(monkeypatch):
    """``RPNET_CORR_IMPL=rot`` at W+2r > 128 raises, as the JAX kernel does."""
    monkeypatch.setenv("RPNET_CORR_IMPL", "rot")
    with pytest.raises(ValueError, match="W\\+2r"):
        tc.correlation_route(torch.zeros((2, 4, 124, 16)), 5, True)
    with pytest.raises(ValueError):
        pc._local_correlation_pallas_rot_impl(jnp.zeros((2, 4, 124, 16)),
                                              jnp.zeros((2, 4, 124, 16)), 5, interpret=True)


# ------------------------------------------------------------ slice level

@pytest.fixture(scope="module")
def cre_pair():
    """The JAX RPNet's CRE (``use_pallas=True``) and the port's, one set of
    weights (randomized norms), r=2."""
    _, variables = jax_rpnet(radius=2, num_iter=1, size=32, seed=4)
    model = JaxRPNet(backbone="UNet", num_iter=1, radius=2, align=False, use_pallas=True)
    port = RPNet(radius=2, num_iter=1)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model, variables, port.eval()


@pytest.mark.parametrize("env,shape,dtype", [
    ({"RPNET_CORR_IMPL": "rot", "RPNET_ROT_PACK": "1"}, (2, 16, 64), "float32"),
    ({"RPNET_CORR_IMPL": "rot", "RPNET_ROT_EXTRACT": "pdot"}, (2, 16, 16), "bfloat16"),
    ({"RPNET_CORR_IMPL": "pallas_mxu"}, (2, 16, 16), "float32"),
    ({"RPNET_CORR_IMPL": "csub"}, (2, 16, 16), "float32"),
], ids=["rot-pack", "rot-pdot-bf16", "pallas_mxu", "csub"])
def test_cre_matches_jax_under_switch(monkeypatch, cre_pair, env, shape, dtype):
    """Eval CRE, port vs JAX with the same weights. Under ``rot`` the JAX
    CRE runs its rot kernels in interpret mode on the CPU (packed pairs at
    W=64; pdot in bf16); under ``pallas_mxu``/``csub`` its XLA formulation,
    of the same values. f32: atol 5e-4 (as ``test_torch_models``); bf16
    (weights, statistics and features all bf16 in both): atol 2⁻⁴ on
    outputs of magnitude up to ~2 (a few bf16 ulps after convolutions whose
    sums round differently; 0.023 measured) and a mean difference under
    2e-3 (7e-4 measured)."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    model, variables, port = cre_pair
    rng = np.random.RandomState(5)
    fts = np.abs(rng.randn(*shape, 256)).astype(np.float32)
    m = (rng.rand(*shape, 1) > 0.5).astype(np.float32)
    fm1, fm2 = fts * m, fts * (1 - m)
    seen = []
    real = port_cre.correlation_route
    monkeypatch.setattr(port_cre, "correlation_route",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    if dtype == "bfloat16":
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), variables)
        (j1, j2), (t1, t2) = _bf16_pair(fm1, fm2)
        port = RPNet(radius=2, num_iter=1)
        port.load_state_dict(state_dict_from_jax(variables), strict=True)
        port = port.eval().to(torch.bfloat16)
    else:
        v, j1, j2 = variables, jnp.asarray(fm1), jnp.asarray(fm2)
        t1, t2 = torch.from_numpy(fm1), torch.from_numpy(fm2)
    ref = np.asarray(model.apply(v, j1, j2, method=lambda mdl, a, b: mdl.cre(a, b, False))
                     .astype(jnp.float32))
    with torch.no_grad():
        out = port.cre(t1, t2).float().numpy()
    assert seen == [{"rot": "pack" if "RPNET_ROT_PACK" in env else "pdot",
                     "pallas_mxu": "band", "csub": "csub"}[env["RPNET_CORR_IMPL"]]]
    assert out.shape == ref.shape == shape + (64,)
    if dtype == "bfloat16":
        diff = np.abs(out - ref)
        assert diff.max() <= 2 ** -4 and diff.mean() < 2e-3, (diff.max(), diff.mean())
    else:
        np.testing.assert_allclose(out, ref, atol=5e-4)


# --------------------------------------------------------------- training

@pytest.mark.parametrize("impl", ["pallas_mxu", "csub"])
def test_sgd_step_matches_under_switch(monkeypatch, weights, impl):  # noqa: F811
    """One SGD step at lr 1 (``test_torch_train.test_sgd_step_matches``'s
    tolerances: loss 1e-4 relative, each tensor's change 10%) with the
    port's CRE on the band / csub forward; the JAX trainer's correlation is
    its XLA formulation on the CPU, of the same values."""
    monkeypatch.setenv("RPNET_CORR_IMPL", impl)
    seen = []
    real = port_cre.correlation_route
    monkeypatch.setattr(port_cre, "correlation_route",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    cfg = _config(optimizer="sgd", init_lr=1.0, momentum=0.9)
    jl, jstate, pl, port = run_both(weights, cfg, [smooth_batch(2)])
    assert set(seen) == {"band" if impl == "pallas_mxu" else "csub"}
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    param_change_close(port, jstate["params"], weights, 0.1)
