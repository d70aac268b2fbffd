"""The host data layer: manifests, labels, batching and the iterators.

The names the JAX package's ``data`` package exports, from the port's own
modules.
"""

from unispeech_tpu_torch.data.batching import (
    batch_by_size,
    bucket_for,
    length_buckets,
    ordered_indices,
    shard_batches,
)
from unispeech_tpu_torch.data.dataset import DataConfig, FinetuneIterator, PretrainIterator
from unispeech_tpu_torch.data.dictionary import Dictionary
from unispeech_tpu_torch.data.labels import (
    LabelFile,
    align_labels_to_frames,
    crop_labels,
    verify_label_lengths,
)
from unispeech_tpu_torch.data.manifest import Manifest, create_manifest, load_audio
from unispeech_tpu_torch.data.mixing import MixingConfig, mix_batch_device, mix_batch_host

__all__ = [
    "batch_by_size", "bucket_for", "length_buckets", "ordered_indices",
    "shard_batches", "DataConfig", "FinetuneIterator", "PretrainIterator",
    "Dictionary", "LabelFile", "align_labels_to_frames", "crop_labels",
    "verify_label_lengths", "Manifest", "create_manifest", "load_audio",
    "MixingConfig", "mix_batch_device", "mix_batch_host",
]
