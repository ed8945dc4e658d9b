"""Buffer-by-buffer streaming (counterpart of after_tpu/streaming).

``Streamer`` and ``CrossfadeDecoder`` are imported on first use: the models
import ``streaming.state``, and the streamer imports the models.
"""

from .state import CrossfadeState, StreamState  # noqa: F401


def __getattr__(name):
    if name == "Streamer":
        from .streamer import Streamer
        return Streamer
    if name == "CrossfadeDecoder":
        from .crossfade import CrossfadeDecoder
        return CrossfadeDecoder
    raise AttributeError(name)
