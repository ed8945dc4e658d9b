"""``after-tpu-torch import_dataset``: a dataset prepared by the PyTorch
reference (AudioExample protobufs in LMDB) -> the port's record store,
without liblmdb or protobuf (the port of after_tpu/cli/import_dataset.py).

    after-tpu-torch import_dataset --input_path ref_db/ --output_path db/

Waveforms, latents, augmented latents, descriptors and metadata carry
over; pickled PrettyMIDI blobs become the port's pickled ``MidiFile``.
"""

from __future__ import annotations

import argparse

from ..dataset.lmdb_import import import_lmdb


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="after-tpu-torch import_dataset",
                                description=__doc__)
    p.add_argument("--input_path", required=True,
                   help="reference LMDB dir (contains data.mdb) or file")
    p.add_argument("--output_path", required=True,
                   help="output record-store directory")
    p.add_argument("--max_records", type=int, default=None)
    args = p.parse_args(argv)
    n = import_lmdb(args.input_path, args.output_path,
                    max_records=args.max_records)
    return 0 if n > 0 else 1
