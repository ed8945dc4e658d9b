"""``after-tpu-torch``: the port's command line, with the JAX package's
subcommands (after_tpu/cli/main.py).

    after-tpu-torch train_autoencoder   codec GAN training
    after-tpu-torch train               diffusion training
    after-tpu-torch export              a2a run -> streaming artifact
    after-tpu-torch export_midi         MIDI run -> streaming artifact
    after-tpu-torch export_autoencoder  codec run -> codec-only artifact
    after-tpu-torch serve               local web frontend

The JAX package's other subcommands are not ported yet: each exits
non-zero and names the ROADMAP item that ports it.
"""

from __future__ import annotations

import sys

PORTED = ["train_autoencoder", "train", "export", "export_midi",
          "export_autoencoder", "serve"]
# subcommand -> the ROADMAP item (section A) that ports it
NOT_PORTED = {
    "prepare_dataset": "13 (dataset preparation and import)",
    "update_dataset": "13 (dataset preparation and import)",
    "import_dataset": "13 (dataset preparation and import)",
    "import_torch": "13 (dataset preparation and import)",
}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] in NOT_PORTED:
        print(f"after-tpu-torch: {argv[0]} is not ported yet (ROADMAP item "
              f"{NOT_PORTED[argv[0]]}); the JAX package's after-tpu runs it",
              file=sys.stderr)
        return 2
    if not argv or argv[0] not in PORTED:
        print("usage: after-tpu-torch {" + ",".join(PORTED) + "} [args...]")
        return 1
    cmd, rest = argv[0], argv[1:]
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
