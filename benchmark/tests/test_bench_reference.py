"""The plain references against the port at a tiny size on the CPU, in
f32, from the benchmark's weights."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH

import weights
from reference import lgca as ref_lgca
from reference import rpnet as ref_rpnet

SKIP = ("source", "reduced", "assumed", "deployment")


def config(name, **kw):
    from rpnet_tpu_torch.config import Config

    with open(os.path.join(BENCH, "configs", name)) as f:
        d = {k: v for k, v in json.load(f).items() if k not in SKIP}
    d.update(kw)
    return Config(d)


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture
def rpnet():
    from rpnet_tpu_torch.models.factory import build_rpnet

    cfg = config("rpnet_unet.json", compute_dtype="float32")
    model = build_rpnet(cfg, num_iter=3)
    sd = weights.draw(weights.template_of(model), torch.Generator().manual_seed(1), "cpu")
    model.load_state_dict(sd)
    return cfg, model, sd


def episode(B=3, H=48, seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((2, B, H, H), generator=g) * 2 - 1
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(H), indexing="ij")
    lab = (((yy - H / 2) ** 2 + (xx - H / 2.3) ** 2) < (H / 4) ** 2).float().expand(B, H, H)
    return img[0], lab.contiguous(), img[1]


def test_registration_matches_the_port():
    from rpnet_tpu_torch.registration.fit import register_episode

    supp, lab, qry = episode()
    got = register_episode(supp, qry, lab, affine_iters=50, fit_scale=1)
    want = ref_rpnet.register(supp, qry, lab, iters=50, lr=0.01, fit_scale=1)
    assert torch.equal(got.warped_label, want["prior"])
    assert float((got.affine_src - want["affine_src"]).abs().max()) < 1e-4
    assert float((got.warped_src - want["warped_src"]).abs().max()) < 1e-4


def test_rpnet_eval_matches_the_port(rpnet):
    cfg, model, sd = rpnet
    supp, lab, qry = episode()
    fore = lab
    with torch.no_grad():
        out = model(supp[None, None, ..., None], fore[None, None], 1 - fore[None, None],
                    qry[..., None], lab)
        want = ref_rpnet.rpnet(sd, supp, fore, 1 - fore, qry, lab, 3, 5, 4)
    assert rel(out["refinement"].permute(0, 1, 4, 2, 3), want["refinement"]) < 1e-5


def test_rpnet_train_forward_matches_the_port(rpnet):
    cfg, model, sd = rpnet
    E, k = 2, 3
    parts = [episode(k, seed=s) for s in range(E)]
    supp = torch.stack([p[0] for p in parts])
    fore = torch.stack([p[1] for p in parts])
    qry = torch.stack([p[2] for p in parts])
    model.train()
    with torch.no_grad():
        out = model(supp[:, None, None, ..., None], fore[:, None, None], 1 - fore[:, None, None],
                    qry[..., None], fore)
        want = ref_rpnet.rpnet(sd, supp.reshape(E * k, 48, 48), fore.reshape(E * k, 48, 48),
                               1 - fore.reshape(E * k, 48, 48), qry.reshape(E * k, 48, 48),
                               fore.reshape(E * k, 48, 48), 3, 5, 4, train=True, episodes=E)
        align = ref_rpnet.align_loss(want, fore.reshape(E * k, 48, 48),
                                     1 - fore.reshape(E * k, 48, 48), E)
    got = out["refinement"].reshape(3, E * k, 48, 48, 2).permute(0, 1, 4, 2, 3)
    assert rel(got, want["refinement"]) < 1e-4
    assert torch.allclose(out["align_loss"], align, rtol=1e-4, atol=1e-6)


def test_reader_matches_the_port(tmp_path):
    from rpnet_tpu_torch.episode.sampler import _shot_rows

    for n_support, nq in ((7, 5), (48, 60), (30, 30)):
        assert np.array_equal(_shot_rows(n_support, nq, 12, 1)[0],
                              ref_rpnet.support_rows(n_support, nq, 12))


@pytest.mark.parametrize("train", [False, True])
def test_lgca_matches_the_port(train):
    from rpnet_tpu_torch.models.factory import build_lgcanet

    cfg = config("lgca_v3.json", num_slice=32, num_x=64, num_y=64)
    model = build_lgcanet(cfg)
    sd = weights.draw(weights.template_of(model), torch.Generator().manual_seed(2), "cpu")
    model.load_state_dict(sd)
    model.train(train)
    g = torch.Generator().manual_seed(3)
    vol = torch.randn((1, 16, 32, 32, 1), generator=g)
    sl = torch.randn((4, 64, 64, 1), generator=g)
    with torch.no_grad():
        out = model(vol, sl)
        want = ref_lgca.lgca(sd, vol.permute(0, 4, 1, 2, 3), sl.permute(0, 3, 1, 2), train=train)
    assert rel(out["seg_2d"].permute(0, 3, 1, 2), want["seg_2d"]) < 1e-4
    assert rel(out["dsv"].permute(0, 4, 1, 2, 3), want["dsv"]) < 1e-5
