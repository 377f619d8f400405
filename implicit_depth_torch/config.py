"""Configuration: nested defaults, YAML overlays and validation.

The port's own copy of ``implicit_depth_tpu/config.py`` (``Config``,
``_DEFAULTS``, ``load_config``, ``validate_config``): every key is kept, so
the same ``configs/*.yaml`` files load. The ``tpu`` section's kernel tile
sizes and Pallas switches are read by the JAX package only; the port accepts
and ignores them. ``yaml`` is imported only where a YAML file is read or
written, so a config built from a dict needs no ``pyyaml``.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, Iterator, List, Optional

_PLACEHOLDER = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class Config:
    """Nested dict with attribute access.

    ``cfg.model.rgb_out`` reads ``d['model']['rgb_out']``. Missing keys raise
    AttributeError. Assignment through attributes is supported and writes into
    the underlying dict so overlays and saves see the update.
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = Config(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._data[name]
        except KeyError:
            raise AttributeError(f"config has no key {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, dict):
            value = Config(value)
        self._data[name] = value

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    # -- overlay / io -------------------------------------------------------
    def update_from(self, other: "Config | Dict[str, Any]") -> None:
        """Deep-merge ``other`` into self (other wins)."""
        items = other.items() if isinstance(other, Config) else other.items()
        for k, v in items:
            if isinstance(v, (Config, dict)) and isinstance(self._data.get(k), Config):
                self._data[k].update_from(v)
            else:
                self._data[k] = Config(dict(v.items())) if isinstance(v, Config) else (
                    Config(v) if isinstance(v, dict) else v
                )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out

    def flat_items(self, prefix: str = "") -> List[tuple]:
        out = []
        for k, v in self._data.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Config):
                out.extend(v.flat_items(key))
            else:
                out.append((key, v))
        return out

    def lookup(self, dotted: str) -> Any:
        node: Any = self
        for part in dotted.split("."):
            node = node._data[part] if isinstance(node, Config) else node[part]
        return node

    def save(self, path: str) -> None:
        import yaml
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    # -- interpolation ------------------------------------------------------
    def interpolate(self) -> None:
        """Resolve ``${a.b.c}`` placeholders in string values, recursively.

        Chained references (a placeholder resolving to a string that itself
        contains a placeholder) are followed until fixpoint.
        """

        def resolve(value: Any, depth: int = 0) -> Any:
            if not isinstance(value, str) or depth > 16:
                return value
            match = _PLACEHOLDER.fullmatch(value)
            if match:  # whole-string reference may return a non-string
                return resolve(self.lookup(match.group(1)), depth + 1)

            def sub(m: re.Match) -> str:
                return str(resolve(self.lookup(m.group(1)), depth + 1))

            new = _PLACEHOLDER.sub(sub, value)
            return new if new == value else resolve(new, depth + 1)

        def walk(node: Config) -> None:
            for k, v in list(node._data.items()):
                if isinstance(v, Config):
                    walk(v)
                elif isinstance(v, str):
                    node._data[k] = resolve(v)

        walk(self)


# Defaults mirror the capability surface of the reference's
# default_config.yaml; the `tpu` section is new.
_DEFAULTS: Dict[str, Any] = {
    "trainer_name": None,
    "exp_type": None,
    "base_log_dir": "logs",
    "log_name": None,
    "custom_postfix": "",
    "checkpoint_path": None,
    # which snapshot to load from checkpoint_path (same choices as
    # lidf_ckpt_name) — e.g. best_network for the test workflow
    "checkpoint_name": "latest_network",
    "lidf_ckpt_path": None,
    # which snapshot to load from lidf_ckpt_path for frozen stage 1
    # ('latest_network' | 'best_network' | 'epochNNN_network')
    "lidf_ckpt_name": "latest_network",
    "resume": None,
    "seed": 0,
    "debug": False,
    "mask_type": "all",
    "dataset": {
        "type": "synthetic",
        "cleargrasp_root_dir": None,
        "omniverse_root_dir": None,
        "use_data_augmentation": False,
        "img_width": 320,
        "img_height": 240,
        "split_ratio": 0.9,
        "max_depth": 4,
        "omni_corrupt_all": True,
        "corrupt_table": True,
        "depth_aug": False,
        "corrupt_all_pix": False,
        "ellipse_dropout_mean": 20,
        "ellipse_gamma_shape": 10.0,
        "ellipse_gamma_scale": 1.0,
        "gamma_shape": 1000.0,
        "gamma_scale": 0.001,
        "gaussian_scale": 0.005,
        "gp_rescale_factor": 4,
        # mask_type='pred' support (pipeline.py:117-129): emit a 'pred_mask'
        # batch key, from pred_mask_dir PNGs or (fallback) the GT corrupt mask
        "provide_pred_mask": False,
        "pred_mask_dir": None,
    },
    "model": {
        "rgb_model_type": "resnet",
        "rgb_embedding_type": "ROIAlign",
        "rgb_in": 3,
        "rgb_out": 32,
        "roi_inp_bbox": 8,
        "roi_out_bbox": 2,
        "pnet_model_type": "twostage",
        "pnet_in": 6,
        "pnet_out": 128,
        "pnet_gf": 32,
        "pnet_pos_type": "rel",
        "pos_encode": True,
        "intersect_pos_type": "abs",
        "multires": 8,
        "multires_views": 4,
        "offdec_type": "IEF",
        "n_iter": 2,
        "probdec_type": "IMNET",
        "imnet_gf": 64,
        "scatter_type": "Maxpool",
        "use_sigmoid": False,
        "maxpool_label_epo": 6,
        # ResNet34 block counts (resnet_dilated.py:283); override for tiny
        # test models
        "resnet_stages": [3, 4, 6, 3],
    },
    "refine": {
        "forward_times": 2,
        "perturb": True,
        "perturb_prob": 0.8,
        "pnet_model_type": "twostage",
        "pnet_in": 6,
        "pnet_out": 128,
        "pnet_gf": 32,
        "pnet_pos_type": "rel",
        "pos_encode": True,
        "intersect_pos_type": "abs",
        "multires": 8,
        "multires_views": 4,
        "offdec_type": "IEF",
        "n_iter": 2,
        "imnet_gf": 64,
        "use_sigmoid": False,
        "offset_range": [-0.2, 0.2],
        "use_all_pix": True,
    },
    "grid": {
        "res": 8,
        "miss_sample_num": 20000,
        "valid_sample_num": 10000,
        "offset_range": [0.0, 1.0],
    },
    "training": {
        "batch_size": 32,
        "valid_batch_size": 1,
        "nepochs": 30,
        "nepoch_decay": 30,
        "decay_gamma": 0.1,
        "nepoch_ckpt": 1,
        # preemption safety (TPU pods are preemptible; the reference only
        # checkpoints per epoch): also write latest_network every N optimizer
        # steps WITHIN an epoch, with enough metadata (step counter + RNG key
        # state) for resume to re-align to the exact step. 0 = off.
        "ckpt_every_steps": 0,
        "log_interval": 5,
        "train_vis_iter": 0,
        "val_vis_iter": 0,
        "test_vis_iter": 0,
        "lr": 0.001,
        "num_workers": 4,
        "worker_type": "thread",   # 'process' for full-res datasets (GIL)
        "do_valid": True,
        "valid_start_epo": 0,
        # validate every Nth epoch (reference: every epoch); the final epoch
        # always validates so best-metric tracking sees the final state
        "valid_interval": 1,
        "optimizer_name": "Adam",
        "scheduler_name": "StepLR",
    },
    "loss": {
        "hard_neg": False,
        "hard_neg_ratio": 0.1,
        # informational: under GSPMD the hard-neg top-k is ALWAYS global
        # (models/lidf.py::hard_neg_mean over the sharded array) — unlike the
        # reference's per-rank-local top-k (pipeline.py:475-478)
        "hard_neg_distributed": True,
        "pos_loss_type": "single",
        "pos_w": 100.0,
        "prob_loss_type": "ray",
        "prob_w": 0.5,
        "surf_norm_w": 10.0,
        "surf_norm_epo": 0,
        "smooth_w": 0.0,
        "smooth_epo": 0,
    },
    # Settings of the JAX package's TPU paths (no reference equivalent). The
    # port reads max_pairs_per_ray, pairs_budget_per_ray, pairs_budget_mode
    # and compute_dtype; it accepts the other keys and ignores them.
    "tpu": {
        "max_pairs_per_ray": 20,     # K slots in the static (R, K) pair tensor
        "pairs_budget_per_ray": 8,   # pairs/ray decoded; 0 = dense (all K)
        "pairs_budget_mode": "per_ray",  # 'per_ray' nearest-K truncation |
                                         # 'global' cross-ray compaction
        "use_pallas_decode": "auto",
        "decode_rays_per_tile": 128,
        "decode_train_rays_per_tile": 384,
        "decode_serve_table": False,
        "host_rss_exit_gb": 0,
        "refine_decode_rows_per_tile": 2000,
        "use_pallas_segmax": False,
        "decode_bwd": "kernel_save",
        "mesh_shape": None,
        "compute_dtype": "bfloat16", # matmul/conv activations dtype
        "sync_batchnorm": True,      # cross-replica BN moments over 'data'
        "remat_backbone": False,     # jax.checkpoint on the ResNet
        "eval_rays_per_chunk": 0,    # 0 => single shot
        # optimizer steps executed per device call (lax.scan over a stacked
        # feed buffer) — amortizes per-step host dispatch/transfer overhead;
        # forced to 1 under cfg.debug or when train_vis_iter is set
        "train_steps_per_call": 8,
    },
}


def default_config() -> Config:
    return Config(copy.deepcopy(_DEFAULTS))


# selector keys with a single (or enumerated) supported implementation; the
# reference raises NotImplementedError on anything else (pipeline.py:53,85,
# 456,772, train_lidf.py:69) — mirror that instead of silently ignoring
_SUPPORTED_SELECTORS = {
    ("model", "rgb_model_type"): ("resnet",),
    ("model", "rgb_embedding_type"): ("ROIAlign",),
    ("model", "pnet_model_type"): ("twostage",),
    ("model", "probdec_type"): ("IMNET", "IMNet"),
    ("model", "offdec_type"): ("IEF", "IMNET", "IMNet"),
    ("model", "scatter_type"): ("Maxpool",),
    ("refine", "pnet_model_type"): ("twostage",),
    ("refine", "offdec_type"): ("IEF", "IMNET", "IMNet"),
    ("loss", "pos_loss_type"): ("single",),
    ("loss", "prob_loss_type"): ("ray",),
    # optimizer_name is validated in train/state.make_optimizer (it accepts
    # any case and adamw); scheduler has a single supported implementation
    ("training", "scheduler_name"): ("StepLR",),
    ("tpu", "decode_bwd"): ("xla", "kernel", "kernel_save", "kernel_save_all"),
    # always-on by SPMD construction: BN moments and the hard-neg top-k are
    # global over the mesh (models/resnet.py, models/lidf.py::hard_neg_mean);
    # a False here would silently run the same code, so reject it
    ("tpu", "sync_batchnorm"): (True,),
    ("loss", "hard_neg_distributed"): (True,),
}


def validate_config(cfg: Config) -> Config:
    """Reject selector values no implementation backs (≙ the reference's
    NotImplementedError paths) rather than silently running something else."""
    for (section, key), allowed in _SUPPORTED_SELECTORS.items():
        val = cfg.get(section, Config({})).get(key)
        # None normally means "key absent — use the default", but for the
        # always-on boolean selectors (allowed == (True,)) a YAML override
        # like `tpu: {sync_batchnorm: null}` must not bypass the check and
        # silently run the always-global code path (ADVICE r3).
        if val is None and allowed != (True,):
            continue
        if val not in allowed:
            raise NotImplementedError(
                f"{section}.{key}={val!r} is not supported (one of {allowed})")
    return cfg


def load_config(*yaml_paths: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Build a config: defaults <- yaml overlays (in order) <- overrides."""
    cfg = default_config()
    if yaml_paths:
        import yaml
    for path in yaml_paths:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        cfg.update_from(data)
    if overrides:
        cfg.update_from(overrides)
    cfg.interpolate()
    return validate_config(cfg)
