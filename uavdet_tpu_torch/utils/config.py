"""Config system.

The reference reads a flat ``params.yaml`` via OmegaConf attribute access
(reference train.py:61, prepare_dataloader.py:55) composed from a Hydra tree
under ``conf/`` by DVC's hydra integration. OmegaConf isn't available here, so
``Config`` provides the same attribute/namespace semantics over plain YAML,
plus a minimal defaults-list composer for the ``conf/`` tree so both surfaces
keep working.

Schema preserved (reference params.yaml:1-139):
  dataset.{root_dir, *_loader_path, batch_size, remote, image_size, workers,
           mosaic, format}
  train.{seed, trainer.{epochs, input_size, profiler, grad_batches,
         train_batches, val_batches, val_check_interval, accelerator, devices,
         precision, grad_clip_val}, checkpoint.{dir, monitor, mode}}
  model.{name, hparams.{anchors, head_scales, lr, lr_scheduler,
         loss_balancing.{obj_scales_w, bbox_w, objectness_w, no_obj_w},
         bbox_loss_fn, attn_temperature, optim.{name, momentum}, layer_config}}

The port's own copy of ``uavdet_tpu/utils/config.py``: PyYAML is imported
only by the functions that read or write YAML, so ``Config`` works where
PyYAML is not installed (build it from a dict).
"""

import copy
import os
from typing import Any, Mapping


class Config:
    """Attribute-access wrapper over nested dicts (OmegaConf-lite)."""

    def __init__(self, data: Mapping[str, Any]):
        object.__setattr__(self, "_data", {})
        for k, v in data.items():
            self._data[k] = Config(v) if isinstance(v, Mapping) else v

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(f"Config has no key {name!r}; keys: {list(data)}")

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = Config(value) if isinstance(value, Mapping) else value

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> dict:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, Config) else copy.deepcopy(v)
        return out

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_params(path: str = "params.yaml") -> Config:
    """Load a flat params.yaml — the runtime source of truth, same as the
    reference's ``OmegaConf.load('params.yaml')``."""
    import yaml
    with open(path) as f:
        return Config(yaml.safe_load(f))


def load_config(conf_dir: str = "conf", model: str | None = None) -> Config:
    """Compose the Hydra-style ``conf/`` tree: ``conf/config.yaml`` with its
    defaults list (``model: <name>`` → ``conf/model/<name>.yaml`` nested under
    the ``model`` key). This mirrors what DVC's hydra integration produces as
    params.yaml (reference .dvc/config:4-5)."""
    import yaml
    with open(os.path.join(conf_dir, "config.yaml")) as f:
        root = yaml.safe_load(f)

    root.pop("hydra", None)
    defaults = root.pop("defaults", [])
    composed: dict = {}
    for entry in defaults:
        if entry == "_self_":
            composed = _deep_merge(composed, root)
            root = {}
        elif isinstance(entry, dict):
            for group, name in entry.items():
                if model is not None and group == "model":
                    name = model
                with open(os.path.join(conf_dir, group, f"{name}.yaml")) as f:
                    composed = _deep_merge(
                        composed, {group: yaml.safe_load(f)})
    composed = _deep_merge(composed, root)  # in case _self_ was absent
    return Config(composed)


def save_params(cfg: Config, path: str = "params.yaml") -> None:
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)
