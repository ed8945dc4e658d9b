"""``after-tpu-torch``: the port's command line, with the JAX package's
subcommands (after_tpu/cli/main.py).

    after-tpu-torch prepare_dataset     corpus -> record store (codec latents)
    after-tpu-torch update_dataset      re-encode a store's latents
    after-tpu-torch import_dataset      reference LMDB dataset -> record store
    after-tpu-torch import_torch        reference PyTorch checkpoint -> run
    after-tpu-torch train_autoencoder   codec GAN training
    after-tpu-torch train               diffusion training
    after-tpu-torch export              a2a run -> streaming artifact
    after-tpu-torch export_midi         MIDI run -> streaming artifact
    after-tpu-torch export_autoencoder  codec run -> codec-only artifact
    after-tpu-torch serve               local web frontend

Each runs on the CUDA card unless given ``--device cpu`` (``import_dataset``
and ``import_torch`` run on the host).
"""

from __future__ import annotations

import sys

PORTED = ["prepare_dataset", "update_dataset", "import_dataset",
          "import_torch", "train_autoencoder", "train", "export",
          "export_midi", "export_autoencoder", "serve"]


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in PORTED:
        print("usage: after-tpu-torch {" + ",".join(PORTED) + "} [args...]")
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "prepare_dataset":
        from . import prepare_dataset
        return prepare_dataset.main(rest)
    if cmd == "update_dataset":
        from . import prepare_dataset
        return prepare_dataset.update_main(rest)
    if cmd == "import_dataset":
        from . import import_dataset
        return import_dataset.main(rest)
    if cmd == "import_torch":
        from . import import_torch
        return import_torch.main(rest)
    if cmd == "train":
        from . import train
        return train.main(rest)
    if cmd.startswith("export"):
        from . import export
        return export.main(cmd, rest)
    if cmd == "serve":
        from . import serve
        return serve.main(rest)
    from . import train_autoencoder
    return train_autoencoder.main(rest)


if __name__ == "__main__":
    sys.exit(main())
