"""Training data: records and their store, datasets and the prefetching
loader, the host collate and the device latent bank."""

from .audio_example import AudioExample  # noqa: F401
from .collate import make_collate_fn, thread_rng_factory  # noqa: F401
from .dataset import CombinedDataset, DataLoader, SimpleDataset  # noqa: F401
from .device_bank import DeviceLatentBank  # noqa: F401
from .midi import MidiFile, Note  # noqa: F401
from .store import RecordReader, RecordWriter  # noqa: F401
