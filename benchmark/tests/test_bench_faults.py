"""The check against broken programs and against its control, on the CPU:
the harness's look for a card skipped, the rest of a run driven with the
timed path broken underneath, and ``correct`` seen to come out false."""

import pytest
import torch

from conftest import cell_on_cpu, run_tiny


def failing(checks):
    return [k for k, (v, lim) in checks.items() if not v <= lim]


@pytest.mark.parametrize("name", ["rpnet_unet.eval.liver8", "lgca_v3.train",
                                  "rpnet_unet.train", "lgca_v3.eval"])
def test_the_control_fails_a_number(name, tmp_path):
    """The reference a step below the configuration's precision, in the
    program's place, fails at least one of the cell's numbers."""
    cell = cell_on_cpu(name, tmp_path)
    assert not failing(cell.check())
    assert failing(cell.check(control=True))


def test_eval_an_altered_feature_map(tmp_path, monkeypatch):
    from rpnet_tpu_torch.models.unet import UNet

    forward = UNet.forward
    monkeypatch.setattr(UNet, "forward", lambda self, x, mask=None: forward(self, x, mask) * 1.2)
    res = run_tiny("rpnet_unet.eval.liver8", tmp_path)
    assert not res["correct"] and res["checks"]["feature_rel_err"]["value"] > 0.15


def test_eval_a_head_with_foreground_and_background_swapped(tmp_path, monkeypatch):
    from rpnet_tpu_torch.models.rpnet import RPNet

    predict = RPNet._predict
    monkeypatch.setattr(RPNet, "_predict",
                        lambda self, q, fg, bg, size: predict(self, q, bg[None], fg[0], size))
    res = run_tiny("rpnet_unet.eval.liver8", tmp_path)
    assert not res["correct"]
    assert res["checks"]["head_rel_err"]["value"] > res["checks"]["head_rel_err"]["limit"]


def test_eval_an_altered_answer(tmp_path, monkeypatch):
    from rpnet_tpu_torch.episode import pipeline

    metrics = pipeline.episode_metrics
    monkeypatch.setattr(pipeline, "episode_metrics",
                        lambda *a: metrics(*a) + torch.tensor([0.0, 0.0, 0.0, 0.01, 0.0] + [0.0] * 10))
    res = run_tiny("rpnet_unet.eval.liver8", tmp_path)
    assert not res["correct"] and res["checks"]["packed_gap"]["value"] >= 0.009


@pytest.mark.parametrize("name", ["lgca_v3.train", "rpnet_unet.train"])
def test_train_a_step_that_leaves_the_state_unchanged(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    res = run_tiny(name, tmp_path)
    assert not res["correct"]


def test_lgca_train_half_of_the_batch_left_out(tmp_path, monkeypatch):
    from rpnet_tpu_torch.models.lgca import LGCANetV3

    loss = LGCANetV3.loss

    def half(pred, target):
        n = pred["seg_2d"].shape[0] // 2
        return loss({"seg_2d": pred["seg_2d"][:n], "dsv": pred["dsv"]},
                    {"mask": target["mask"][:n],
                     "downsampled_volume_mask": target["downsampled_volume_mask"]})

    monkeypatch.setattr(LGCANetV3, "loss", staticmethod(half))
    res = run_tiny("lgca_v3.train", tmp_path)
    assert not res["correct"]


def test_rpnet_train_half_of_the_batch_left_out(tmp_path, monkeypatch):
    from rpnet_tpu_torch.train import trainer

    update = trainer._update
    monkeypatch.setattr(trainer, "_update", lambda opt, state, seg, align, sc: update(
        opt, state, seg[: len(seg) // 2], align[: len(align) // 2], sc))
    res = run_tiny("rpnet_unet.train", tmp_path)
    assert not res["correct"]


def test_lgca_eval_an_altered_answer(tmp_path, monkeypatch):
    from rpnet_tpu_torch.train import lgca

    evaluate = lgca.evaluate_lgca_volume
    monkeypatch.setattr(lgca, "evaluate_lgca_volume", lambda *a, **k: {
        c: (None if d is None else d + 1e-3) for c, d in evaluate(*a, **k).items()})
    res = run_tiny("lgca_v3.eval", tmp_path)
    assert not res["correct"] and res["checks"]["answer_gap"]["value"] > 0


def test_lgca_eval_altered_context_features(tmp_path, monkeypatch):
    from rpnet_tpu_torch.models.lgca import FeatureNet

    forward = FeatureNet.forward
    monkeypatch.setattr(FeatureNet, "forward", lambda self, x: {
        k: v * 1.2 for k, v in forward(self, x).items()})
    res = run_tiny("lgca_v3.eval", tmp_path)
    assert not res["correct"] and res["checks"]["context_rel_err"]["value"] > 0.15


def test_lgca_eval_a_skipped_slice_attention(tmp_path, monkeypatch):
    from rpnet_tpu_torch.models.lgca import MultiHeadAttentionLayer

    forward = MultiHeadAttentionLayer.forward

    def skipped(self, feat_2d, feat_3d):
        fused, att = forward(self, feat_2d, feat_3d)
        return torch.zeros_like(fused), att

    monkeypatch.setattr(MultiHeadAttentionLayer, "forward", skipped)
    res = run_tiny("lgca_v3.eval", tmp_path)
    assert not res["correct"]
    assert res["checks"]["logits_ratio"]["value"] > res["checks"]["logits_ratio"]["limit"]
