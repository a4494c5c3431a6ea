"""Export an RP_Net episode program as a serving artifact.

    python -m rpnet_tpu_torch.cli.export --yaml cfg.yml --out DIR [--slices N] \
        [--platform cpu]

The counterpart of ``rpnet_tpu/cli/export.py``: the YAML's eval episode
program (test-time refinement depth, registration settings, ``n_way``,
``multishot_fusion``) becomes ``DIR/program.pt2`` and ``DIR/manifest.json``
(``rpnet_tpu_torch/serve/export.py``), which ``cli.serve`` runs with no
model built. Shapes are static: ``--slices`` query slices an episode,
``slice_bucket`` by default. The network runs in the YAML's
``compute_dtype`` (bfloat16 when unset, as the eval CLI); the weights stay
f32 inputs, cast inside the program. The YAML's ``ckpt`` (a ``.pth``), if
any, is loaded into the network to check that it fits, and recorded in the
manifest as the weights ``cli.serve`` takes by default. The correlation route is the one the
``RPNET_*`` variables select now. The program is traced on the card
(``--platform gpu``, the default; raises without one) or on the CPU
(``--platform cpu``), and serves on that device type only.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from rpnet_tpu_torch.cli.test_rpnet import load_checkpoint_into, resolve_device
from rpnet_tpu_torch.config import Config, load_yaml
from rpnet_tpu_torch.models.factory import build_rpnet
from rpnet_tpu_torch.serve.export import (correlation_ops, export_episode_program,
                                          graph_nodes, save_artifact, weight_names)

parser = argparse.ArgumentParser(description="RP-Net serving export (PyTorch)")
parser.add_argument("--yaml", required=True, type=str)
parser.add_argument("--out", required=True, type=str, help="artifact directory to write")
parser.add_argument("--slices", default=None, type=int,
                    help="query slices an episode (default: slice_bucket)")
parser.add_argument("--platform", default="gpu", choices=("gpu", "cpu"),
                    help="gpu (default; raises without one) or cpu")


def main(argv=None) -> str:
    args = parser.parse_args(argv)
    device = resolve_device(args.platform)
    config = Config(load_yaml(args.yaml))
    # serving is eval: the test-time refinement depth (test_rpnet.py:51)
    config = config.replace(n_iter_refinement=config["n_test_iter_refinement"])
    if config["net"] != "RP_Net":
        raise NotImplementedError(f"net: {config['net']!r}; the serving artifact is "
                                  "RP_Net's episode program")
    seed = int(config.get("seed", 0))
    model = build_rpnet(config, num_iter=config["n_iter_refinement"], seed=seed)
    load_checkpoint_into(model, config)

    H, W = config.get("crop_size", [256, 256])
    multishot = bool(config.get("multishot_fusion", False))
    # the shots the eval sampler gives an episode: one a support volume with
    # use_all_supports, else test_shot
    shots = int(config["n_shot"] if config.get("use_all_supports") else config["test_shot"])
    compute_dtype = getattr(torch, config.get("compute_dtype") or "bfloat16")
    slices = int(args.slices or config.get("slice_bucket", 32))
    t0 = time.perf_counter()
    exported = export_episode_program(
        model, slices=slices, height=H, width=W, shots=shots,
        affine_iters=int(config.get("reg_affine_iters", 50)),
        demons_iters=(int(config.get("reg_demons_iters", 50))
                      if config.get("do_deformable", False) else 0),
        fit_scale=int(config.get("reg_fit_scale", 1)),
        sampler=str(config.get("reg_sampler", "matmul")), multishot=multishot,
        n_way=int(config.get("n_way", 1)),
        use_registration=bool(config.get("use_registration_loss", True)),
        reg_lr=float(config.get("reg_lr", 0.01)),
        reg_sigma=float(config.get("reg_sigma", 2.0)),
        compute_dtype=compute_dtype, device=device)
    seconds = time.perf_counter() - t0
    names = weight_names(model)
    sd = model.state_dict()
    save_artifact(exported, args.out, names, extra_manifest={
        "net": config["net"], "compute_dtype": str(compute_dtype).replace("torch.", ""),
        "n_params": sum(sd[n].numel() for n in names),
        "ckpt": config.get("ckpt") or None, "export_seconds": seconds})
    size = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(f"[exported the RP_Net episode program for {device.type} in {seconds:.2f}s: "
          f"{sum(1 for _ in graph_nodes(exported))} graph nodes, correlation ops "
          f"{correlation_ops(exported)}, {size} bytes → {args.out}]")
    return args.out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
