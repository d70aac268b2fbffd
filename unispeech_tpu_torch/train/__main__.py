"""``python -m unispeech_tpu_torch.train``: the training CLI.

Not ported yet: it needs the data pipeline (datasets, batching, label
loading, iterators). The library's train step (``train/state.py``) is.
"""

import sys


def main(argv=None) -> int:
    raise NotImplementedError(
        "the training CLI is not ported to PyTorch yet: drive "
        "unispeech_tpu_torch.train.state.make_train_step from Python")


if __name__ == "__main__":
    sys.exit(main())
