"""Serve an exported artifact: the episodic eval protocol with no model built.

    python -m rpnet_tpu_torch.cli.serve --artifact DIR --yaml cfg.yml \
        [--ckpt x.pth] [--platform cpu] [--n-runs N]

The counterpart of ``rpnet_tpu/cli/serve.py``. The program written by
``cli.export`` is reloaded (``serve/export.load_artifact``) and driven
through the live CLI's protocol (``cli/test_rpnet.run_eval_protocol``):
the same per-episode log lines, per-episode fault isolation, ``n_runs``
mean±std and ``results_eval.json``, the log teed to ``out_dir/log_serve``.
The YAML gives the data and protocol half (dataset paths, eval classes,
``n_runs``, seed, the data path); the network and its episode program come
from the artifact, the weights from a ``.pth``: ``--ckpt``, else the YAML's
``ckpt``, else the manifest's. It runs on the card (``--platform gpu``, the
default; raises without one) or on the CPU (``--platform cpu``), on the
device type the artifact was exported for.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np

from rpnet_tpu_torch.cli.test_rpnet import resolve_device, run_eval_protocol
from rpnet_tpu_torch.config import Config, load_yaml
from rpnet_tpu_torch.episode.sampler import EpisodeSampler
from rpnet_tpu_torch.serve.export import load_artifact, make_artifact_runner
from rpnet_tpu_torch.train.convert import load_torch_checkpoint
from rpnet_tpu_torch.utils.logger import Logger

parser = argparse.ArgumentParser(description="RP-Net artifact serving (PyTorch)")
parser.add_argument("--artifact", required=True, type=str,
                    help="artifact directory written by cli.export")
parser.add_argument("--yaml", required=True, type=str,
                    help="data/protocol config (dataset paths, eval classes, n_runs, seed)")
parser.add_argument("--ckpt", default=None, type=str,
                    help=".pth weights (default: the YAML's ckpt, else the manifest's)")
parser.add_argument("--platform", default="gpu", choices=("gpu", "cpu"),
                    help="gpu (default; raises without one) or cpu")
parser.add_argument("--n-runs", default=None, type=int)


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.platform)
    config = Config(load_yaml(args.yaml))
    # serving is eval: the test-time refinement depth (test_rpnet.py:51); the
    # iteration count itself is the artifact's
    config = config.replace(n_iter_refinement=config["n_test_iter_refinement"])

    seed = int(config.get("seed", 0))
    np.random.seed(seed)
    random.seed(seed)

    out_dir = config.get("out_dir") or "./results/{}/".format(
        os.path.splitext(os.path.basename(args.yaml))[0])
    os.makedirs(out_dir, exist_ok=True)
    logger = Logger(os.path.join(out_dir, "log_serve"))
    sys.stdout = logger
    try:
        program = load_artifact(args.artifact, device)
        man = program.manifest
        print(f"[artifact {args.artifact}: {man.get('net', '?')} slices={man['slices']} "
              f"device={man['device_type']} compute_dtype={man.get('compute_dtype')} "
              f"correlation {man.get('correlation_ops')} {man.get('route_variables')}]")
        ckpt = args.ckpt or config.get("ckpt") or man.get("ckpt")
        if not ckpt:
            print("No checkpoint (--ckpt, YAML ckpt, or manifest ckpt)")
            return None
        print(f"[Loading weights from {ckpt}]")
        state_dict = load_torch_checkpoint(ckpt)["state_dict"]
        sampler = EpisodeSampler(config["data_dir"], config["eval_set_name"], config)
        print(f"[length of eval loader {len(sampler)}]")
        runner = make_artifact_runner(program, state_dict, config, device)
        n_runs = args.n_runs or config.get("n_runs", 1)
        return run_eval_protocol(runner, sampler, config, out_dir, n_runs)
    finally:
        sys.stdout = logger.terminal
        logger.close()


if __name__ == "__main__":
    main()
