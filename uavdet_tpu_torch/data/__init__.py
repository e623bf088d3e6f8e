"""The data hand-off of the port: manifests, the synthetic writer, the frame
stage and the pipeline that hands batches to the device."""
from .antiuav import build_index, save_manifest, load_manifest
from .frames import make_transform
from .pipeline import DataPipeline
from .synthetic import make_synthetic_dataset
