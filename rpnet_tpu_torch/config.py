"""Config system: the YAML experiment file is the public interface.

The port's own copy of ``rpnet_tpu/config.py`` (the port imports nothing of
the JAX package), cut to the keys the port reads, so both CLIs read one
YAML identically. The schema is the reference's (upstream yamls/example.yml,
loaded by utils/util.py:79-88 `load_yaml`): a single flat YAML dict drives
data paths, episode shape, model choice, registration switches, refinement
settings and the eval protocol. Keys the port does not read pass through
unchanged.

:class:`Config` adds the defaults in one place (the reference scatters
`.get()` defaults through the code, e.g. `scale` at net/rp_net.py:200 and
`crop_size` at dataset/few_shot_reader.py:341).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import yaml


def load_yaml(path: str) -> Dict[str, Any]:
    """Load a YAML experiment file into its flat dict."""
    with open(path) as f:
        return yaml.load(f, Loader=yaml.FullLoader)


# Defaults of every key the port reads, as the JAX package sets them.
_DEFAULTS: Dict[str, Any] = {
    # --- data geometry (few_shot_reader.py:385-398, :341-343) ---
    "num_slice": 280,
    "num_x": 272,
    "num_y": 272,
    "crop_size": [256, 256],
    "pad_value": -1024,
    "HU_range": [-1024, 3072],
    # --- brain/volume reader geometry (brain_reader.py:297-358;
    #     episode/brain.py reads them) ---
    "train_max_crop_size": [256, 256, 256],
    "test_max_size": [256, 320, 320],
    "jitter_range": [4, 16, 16],
    "bbox_border": 8,
    # --- episode shape (few_shot_reader.py:256-257, :464-473, :517) ---
    "n_shot": 1,
    "n_way": 1,
    "k": 12,
    "test_shot": None,         # defaults to n_shot (few_shot_reader.py:517)
    # --- splits ---
    "data_dir": "",
    "train_set_name": "split/abd_110_train.csv",
    "eval_set_name": "split/abd_110_test.csv",
    "class_csv_dir": "./split/abd_110_classes",
    "train_classes": ["Spleen", "Kidney L", "Kidney R"],
    "eval_classes": ["Liver"],
    # --- model (net/model.py:4-7, net/rp_net.py:195-224) ---
    "net": "RP_Net",
    "backbone": "UNet",        # vgg | UNet | resnet | sam_vit (SAM's ViT
                               # image encoder, eval only)
    "scale": None,             # feature-map downsample used for mask pooling:
                               # 8 for vgg, 4 otherwise (rpnet_tpu/models/
                               # factory.py:22; set in Config)
    "unet_normalize_type": "BatchNorm2d",
    "mask_feature_map": "no",  # U-Net mask injection: x, x2, x3, x5 or no
    "use_relation_enc": "relation",  # relation | concat
    "pretrained_path": None,   # train CLI warm start (VGG16 or a full RP_Net
                               # .pth); with sam_vit a SAM / MedSAM .pth whose
                               # image_encoder.* fills the encoder
    # --- refinement (net/rp_net.py:201, :281-312; example.yml:107-110) ---
    "n_iter_refinement": 4,
    "n_test_iter_refinement": 10,
    "soft_mask": False,
    "mask_refinement_correlation_radius": 5,
    # --- registration (few_shot_reader.py:556-557, example.yml:99-101) ---
    "use_registration_loss": True,
    "do_deformable": False,
    "reg_affine_iters": 50,    # few_shot_reader.py:159 iters=[50, ...]
    "reg_lr": 0.01,            # few_shot_reader.py:148-149
    "reg_fit_scale": 1,        # fit theta on an image pooled by N (1 = reference-exact)
    "reg_demons_iters": 50,    # demons Adam steps when do_deformable
    "reg_sigma": 2.0,          # demons Gaussian regulariser σ (full resolution)
    "reg_sampler": "matmul",   # demons structure: matmul (pooled fit, the
                               # JAX default) | gather (register_slice's)
    # --- augmentation (example.yml:34,111-114) ---
    "do_intaug": True,
    "gamma_range": [0.5, 1.5],
    "do_elastic": True,        # BrainReader's elastic augmentation (train mode)
    # --- training (example.yml:62-73; trainer.py:46-218) ---
    "batch_size": 4,
    "optimizer": "Adam",
    "init_lr": 1e-5,
    "momentum": 0.9,
    "weight_decay": 1e-4,
    "epochs": 100,
    "epoch_save": 1,
    "scheduler_step": 30,
    "loss": "dice_ce",
    "align_loss_scaler": 1.0,
    # --- eval protocol (test_rpnet.py:112-145) ---
    "n_runs": 5,
    "ckpt": None,
    "out_dir": None,
    "seed": 0,
    # --- additions of the JAX package that the port keeps ---
    "max_slices": 288,         # cap on query slices per episode
    "compute_dtype": None,     # None = bfloat16 network, f32 registration
                               # and metrics; float32 pins f32 throughout
    "use_native_io": True,     # C++ NRRD decoder + raw cache (core/native_cache)
    "io_cache_dir": None,      # where .rawcache files go (default: beside the NRRDs)
    "volume_cache": 8,         # sampler LRU over preprocessed volumes
                               # (entries; 0 disables): eval revisits the
                               # same volumes every run
    "device_volume_cache": 16,  # device-resident (pid, roi) volume LRU for
                                # eval (entries; 0 disables): episodes ship
                                # as slice indices (EpisodeSpec)
    "num_workers": 4,           # eval prefetch threads when the device
                                # cache is off (episode/prefetch.py)
    "use_all_supports": False,  # one shot per support volume (eval)
    "multishot_fusion": False,  # register every shot, fuse over shots
    "eval_3d": False,           # whole-volume sliding-window eval
    "overlap_3d": 8,            # z-overlap between eval_3d windows
    "slice_bucket": 32,         # eval_3d window (the JAX runner's bucket,
                                # rounded up to a sharded runner's data axis)
    "mesh_shape": None,         # e.g. {"data": 2}: resolved per process
                                # (parallel/mesh.resolve_local_mesh); a data
                                # axis above 1 shards in process
    # multihost, coordinator_address, num_processes, process_id (the process
    # group, parallel/mesh.maybe_initialize_distributed) and debug_nans
    # (utils/profiling.enable_nan_debugging) are read with .get, as the JAX
    # package reads them
    # --- LGCANet_V3 (lgca_net_v3.py; rpnet_tpu/episode/lgca_data.py) ---
    "context_net_downsample_scale": [2, 2, 2],   # context volume stride (z, y, x)
}

# LGCANet_V3 keys that the JAX package reads with a default in its code, not
# in its Config (``rpnet_tpu/episode/lgca_data.py:60``,
# ``rpnet_tpu/models/factory.py:43-46``); the same defaults here.
_LGCA_DEFAULTS: Dict[str, Any] = {
    "lgca_slices": 8,           # 2D slices per training step
    "net_UNet": "U_Net",        # U_Net | AttU_Net (attention gates)
    "feature_scale": 1.0,       # 2D U-Net widths 64..1024 divided by this
}


# The widths of ``backbone: sam_vit``, a key of the port alone (the JAX
# package has no such backbone): ``build_sam_vit_b``'s; a YAML's ``sam_vit``
# dict overrides the keys it gives.
SAM_VIT_B: Dict[str, Any] = {"img_size": 1024, "patch_size": 16, "embed_dim": 768,
                             "depth": 12, "num_heads": 12,
                             "global_attn_indexes": [2, 5, 8, 11], "window_size": 14,
                             "out_chans": 256}


@dataclasses.dataclass
class Config:
    """The flat YAML dict over the defaults; ``cfg[key]`` / ``cfg.get(key,
    default)`` as on a dict."""

    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        merged = dict(_DEFAULTS, **_LGCA_DEFAULTS)
        merged.update({k: v for k, v in self.raw.items() if v is not None or k not in merged})
        if merged.get("test_shot") is None:
            merged["test_shot"] = merged["n_shot"]
        merged["sam_vit"] = dict(SAM_VIT_B, **(self.raw.get("sam_vit") or {}))
        if merged.get("scale") is None:
            merged["scale"] = 8 if merged["backbone"] == "vgg" else 4
        self._d = merged

    def __getitem__(self, key):
        return self._d[key]

    def get(self, key, default=None):
        return self._d.get(key, default)

    def replace(self, **kw) -> "Config":
        d = dict(self.raw)
        d.update(kw)
        return Config(d)
