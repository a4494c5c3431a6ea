"""RP_Net's ``sam_vit`` backbone (``models/sam_vit.py``) against plain
references, on the CPU in f32.

The encoder is held against ``tests/sam_vit_reference.py`` (SAM's
equations in plain torch) at a size that forces window padding: 160² images,
patch 16 (10 tokens a side), windows of 4 (padded to 12: the last window
row and column hold padded tokens), 4 blocks with global attention at 1 and
3, width 64 in 4 heads, 32 output channels. Weights are drawn so that no
part of the attention is trivial: LayerNorm scales U(0.8, 1.2) and shifts
U(±0.1), linear and conv weights He-normal, ``pos_embed`` N(0, 1), the
relative-position tables N(0, 2/head_dim), biases U(±0.05). RP_Net's eval
with the backbone runs against the benchmark's plain RP_Net reference on
the ViT (``benchmark/reference/sam_vit.py``), and through the eval CLI's
``build_runner`` and ``evaluate`` on a synthetic split.

Tolerances: both sides compute in f32 with sums in other orders (the patch
embedding as one product over 768 terms against a conv, the fused attention
against an explicit softmax): ``F32_REL`` = 1e-4 of a tensor's norm, about
70 times the rounding seen (1.4e-6 on the encoder). Each planted fault (the
relative positions dropped, the padded keys masked, the window order
transposed in the partition) moves the encoder's output by 0.48–0.80 of
its norm and fails the encoder and the RP_Net comparisons.
"""

import importlib.util
import os
import sys

import pytest
import torch
import yaml
from torch import nn

import sam_vit_reference as ref
from rpnet_tpu_torch.cli import train as train_cli
from rpnet_tpu_torch.cli.test_rpnet import build_runner, evaluate
from rpnet_tpu_torch.config import SAM_VIT_B, Config
from rpnet_tpu_torch.core.synthetic import generate_dataset
from rpnet_tpu_torch.episode.sampler import EpisodeSampler
from rpnet_tpu_torch.models import sam_vit
from rpnet_tpu_torch.models.factory import build_rpnet
from rpnet_tpu_torch.models.sam_vit import (SamViTEncoder, rel_expand, rel_index,
                                            rel_pos_bias)

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(img_size=160, patch_size=16, embed_dim=64, depth=4, num_heads=4,
             global_attn_indexes=[1, 3], window_size=4, out_chans=32)
CROP = 40      # RP_Net's crop: 10 features a side at scale 4, as the ViT's 160/16
F32_REL = 1e-4


def rel(a, b):
    return float((a - b).norm() / b.norm())


def draw(module, seed=0):
    """Weights for ``module`` (see the module doc), in place; → its state dict."""
    g = torch.Generator().manual_seed(seed)
    norms = {n for n, m in module.named_modules() if isinstance(m, (nn.LayerNorm, nn.BatchNorm2d))}
    sd = {}
    for name, t in module.state_dict().items():
        prefix, _, leaf = name.rpartition(".")
        u = torch.rand(t.shape, generator=g)
        if not t.is_floating_point():
            sd[name] = t
        elif prefix in norms:
            sd[name] = 0.8 + 0.4 * u if leaf in ("weight", "running_var") else 0.2 * u - 0.1
        elif leaf == "pos_embed":
            sd[name] = torch.randn(t.shape, generator=g)
        elif leaf.startswith("rel_pos"):
            sd[name] = torch.randn(t.shape, generator=g) * (2.0 / t.shape[1]) ** 0.5
        elif t.dim() >= 2:
            sd[name] = torch.randn(t.shape, generator=g) * (2.0 / t[0].numel()) ** 0.5
        else:
            sd[name] = 0.1 * u - 0.05
    module.load_state_dict(sd)
    return module.state_dict()


def images(n, size, seed=1):
    """Smooth images in [-1, 1]: a few blobs on noise."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, size), torch.linspace(-1, 1, size),
                            indexing="ij")
    out = []
    for _ in range(n):
        c = torch.rand(4, 2, generator=g) * 1.6 - 0.8
        img = sum(torch.exp(-((yy - a) ** 2 + (xx - b) ** 2) * 12) for a, b in c)
        out.append(img + 0.1 * torch.randn(size, size, generator=g))
    return (torch.stack(out).clamp(0, 1) * 2 - 1)


@pytest.fixture(scope="module")
def encoder():
    enc = SamViTEncoder(**SMALL)
    draw(enc, seed=3)
    return enc.eval()


def test_encoder_matches_reference(encoder):
    x = ref.rpnet_input(images(2, 40), SMALL["img_size"])
    sd = {"encoder." + k: v for k, v in encoder.state_dict().items()}
    want = ref.image_encoder(x, sd, SMALL)
    with torch.no_grad():
        got = encoder(x.permute(0, 2, 3, 1).contiguous())
    assert got.shape == (2, 10, 10, 32)
    assert rel(got.permute(0, 3, 1, 2), want) < F32_REL


def test_rel_pos_bias_against_a_direct_table():
    """The decomposed bias at key kh·W + kw of query qh·W + qw is
    q·(rel_pos_h[qh − kh + H − 1] + rel_pos_w[qw − kw + W − 1]), on a
    map that is not square."""
    H, W, C = 3, 5, 4
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, H * W, C, generator=g)
    th, tw = torch.randn(2 * H - 1, C, generator=g), torch.randn(2 * W - 1, C, generator=g)
    got = rel_pos_bias(q, th, tw, (H, W), rel_index(H), rel_index(W), rel_expand(H, W))
    want = torch.empty(2, 3, H * W, H * W)
    for i in range(H * W):
        for j in range(H * W):
            (qh, qw), (kh, kw) = divmod(i, W), divmod(j, W)
            want[:, :, i, j] = q[:, :, i] @ (th[qh - kh + H - 1] + tw[qw - kw + W - 1])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # in bf16 the product adds the two terms and rounds once, as the
    # elementwise add of SAM's code does: bit for bit
    qb, thb, twb = q.bfloat16(), th.bfloat16(), tw.bfloat16()
    rq = qb.reshape(2, 3, H, W, C)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, thb[rel_index(H)])
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, twb[rel_index(W)])
    added = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(2, 3, H * W, H * W)
    got = rel_pos_bias(qb, thb, twb, (H, W), rel_index(H), rel_index(W),
                       rel_expand(H, W).bfloat16())
    assert torch.equal(got, added)


def _rpnet(**kw):
    cfg = dict(backbone="sam_vit", crop_size=[CROP, CROP], sam_vit=SMALL,
               mask_refinement_correlation_radius=2, n_iter_refinement=3)
    cfg.update(kw)
    model = build_rpnet(cfg, seed=0)
    draw(model, seed=5)
    return model.eval()


def test_micro_batches_match_one_batch_and_are_counted(monkeypatch):
    model = _rpnet()
    imgs = images(5, CROP)[..., None]
    before = dict(sam_vit.attention_calls)
    with torch.no_grad():
        whole = model._encode(imgs, None)
        after_one = dict(sam_vit.attention_calls)
        monkeypatch.setattr(model.encoder, "slices_per_pass", lambda x: 2)
        parts = model._encode(imgs, None)
    # one pass: a call per block; three passes of 2, 2 and 1 slices
    assert {k: after_one[k] - before[k] for k in before} == {"windowed": 2, "global": 2}
    assert {k: sam_vit.attention_calls[k] - after_one[k] for k in before} == {
        "windowed": 6, "global": 6}
    assert rel(parts, whole) < F32_REL


def test_slices_per_pass_from_memory():
    enc = SamViTEncoder(**SMALL)
    x = torch.zeros(1, 160, 160, 1)
    T, D = 100, 64
    assert enc.slices_per_pass(x) == sam_vit.CPU_PASS_BYTES // (4 * (4 * T * T + 16 * T * D))
    with torch.device("meta"):
        vit_b = SamViTEncoder()
    # ViT-B in bf16: a global block's bias of 12 × 4096² values, 403 MB a slice
    per_slice = 2 * (12 * 4096 ** 2 + 16 * 4096 * 768)
    assert vit_b.slices_per_pass(torch.zeros(1, dtype=torch.bfloat16)) == \
        sam_vit.CPU_PASS_BYTES // per_slice


def test_rpnet_eval_matches_the_plain_reference():
    bench = os.path.join(ROOT, "benchmark")
    sys.path.insert(0, bench)
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_sam_reference", os.path.join(bench, "reference", "sam_vit.py"))
        bref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bref)
    finally:
        sys.path.remove(bench)
    model = _rpnet()
    B, H = 3, CROP
    g = torch.Generator().manual_seed(7)
    supp, qry = images(B, H, seed=8), images(B, H, seed=9)
    fore = (torch.rand(B, H, H, generator=g) > 0.6).float()
    appr = (torch.rand(B, H, H, generator=g) > 0.5).float()
    with torch.no_grad():
        out = model(supp[None, None, ..., None], fore[None, None], 1 - fore[None, None],
                    qry[..., None], appr)
    logits = out["refinement"].permute(0, 1, 4, 2, 3)                   # (T, B, 2, H, W)
    chain = (torch.softmax(logits[:-1], 2)[:, :, 1] > 0.5).float()
    sd = model.state_dict()
    want = bref.rpnet(sd, supp, fore, 1 - fore, qry, appr, 3, 2, 4, masks=chain,
                      widths=SMALL)["refinement"]
    assert rel(logits, want) < F32_REL
    # the backbone's part: another encoder moves the logits
    sd_other = dict(sd, **{"encoder.blocks.0.attn.rel_pos_h": sd["encoder.blocks.0.attn.rel_pos_h"] * 0})
    moved = bref.rpnet(sd_other, supp, fore, 1 - fore, qry, appr, 3, 2, 4, masks=chain,
                       widths=SMALL)["refinement"]
    assert rel(moved, want) > 100 * F32_REL


def test_vit_b_parameters_and_names():
    cfg = Config({"backbone": "sam_vit"})
    assert cfg["sam_vit"] == SAM_VIT_B and cfg["scale"] == 4
    assert Config({"backbone": "sam_vit", "sam_vit": {"depth": 2}})["sam_vit"] == dict(
        SAM_VIT_B, depth=2)
    with torch.device("meta"):
        enc = SamViTEncoder(**cfg["sam_vit"])
    assert sum(p.numel() for p in enc.parameters()) == 89_670_912
    names = {"pos_embed", "patch_embed.proj.weight", "patch_embed.proj.bias",
             "neck.0.weight", "neck.1.weight", "neck.1.bias", "neck.2.weight",
             "neck.3.weight", "neck.3.bias"}
    for i in range(12):
        names |= {f"blocks.{i}.{n}" for n in (
            "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
            "attn.proj.weight", "attn.proj.bias", "attn.rel_pos_h", "attn.rel_pos_w",
            "norm2.weight", "norm2.bias", "mlp.lin1.weight", "mlp.lin1.bias",
            "mlp.lin2.weight", "mlp.lin2.bias")}
    sd = enc.state_dict()
    assert set(sd) == names
    assert sd["blocks.2.attn.rel_pos_h"].shape == (127, 64)
    assert sd["blocks.0.attn.rel_pos_w"].shape == (27, 64)
    assert sd["pos_embed"].shape == (1, 64, 64, 768)
    assert sd["neck.2.weight"].shape == (256, 256, 3, 3)


def test_sam_checkpoint_loads_by_rename(tmp_path):
    model = _rpnet()
    g = torch.Generator().manual_seed(11)
    sam = {"image_encoder." + k: torch.randn(v.shape, generator=g)
           for k, v in model.encoder.state_dict().items()}
    sam["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = torch.zeros(2, 128)
    sam["mask_decoder.iou_token.weight"] = torch.zeros(1, 256)
    torch.save(sam, tmp_path / "medsam.pth")
    cfg = dict(backbone="sam_vit", crop_size=[CROP, CROP], sam_vit=SMALL,
               pretrained_path=str(tmp_path / "medsam.pth"))
    loaded = build_rpnet(cfg, seed=0)
    for k, v in loaded.encoder.state_dict().items():
        torch.testing.assert_close(v, sam["image_encoder." + k], rtol=0, atol=0)
    # the rest of the model keeps its seeded init
    fresh = build_rpnet(dict(cfg, pretrained_path=None), seed=0)
    torch.testing.assert_close(loaded.cre.state_dict(), fresh.cre.state_dict())
    del sam["image_encoder.neck.3.bias"]
    torch.save({"state_dict": sam}, tmp_path / "partial.pth")
    with pytest.raises(ValueError, match="neck.3.bias"):
        build_rpnet(dict(cfg, pretrained_path=str(tmp_path / "partial.pth")))


def test_train_cli_refuses_the_backbone(tmp_path):
    path = tmp_path / "sam.yml"
    path.write_text(yaml.safe_dump({"backbone": "sam_vit", "out_dir": str(tmp_path / "out")}))
    with pytest.raises(NotImplementedError, match="sam_vit"):
        train_cli.main(["--yaml", str(path), "--platform", "cpu"])
    assert not (tmp_path / "out").exists()


def test_eval_cli_runs_the_backbone(tmp_path):
    """``build_runner`` and ``evaluate``, the eval CLI's own, on the same
    runner, sampler and registration as the U-Net."""
    paths = generate_dataset(str(tmp_path / "data"), n_train=1, n_test=2, shape=(10, 48, 48),
                             classes=("Liver",), seed=2)
    config = Config(dict(data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
                         eval_set_name=paths["test_csv"], num_slice=16, num_x=48, num_y=48,
                         crop_size=[CROP, CROP], k=3, eval_classes=["Liver"],
                         backbone="sam_vit", sam_vit=SMALL, n_iter_refinement=2,
                         mask_refinement_correlation_radius=2, reg_affine_iters=3,
                         max_slices=3, compute_dtype="float32"))
    runner = build_runner(config, torch.device("cpu"))
    sampler = EpisodeSampler(config["data_dir"], config["eval_set_name"], config)
    before = sam_vit.attention_calls["global"]
    affine, fewshot, _, failures = evaluate(runner, sampler, config)
    assert failures == 0 and len(fewshot["Liver"]) == len(sampler) == 2
    assert all(d is None or 0 <= d <= 1 for d in fewshot["Liver"])
    assert sam_vit.attention_calls["global"] - before == 2 * len(sampler)
