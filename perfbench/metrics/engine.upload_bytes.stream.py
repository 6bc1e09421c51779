"""``engine.upload_bytes`` in the stream cell, where the engine's input
upload moves ``latency_p99_ms``: the same reader, loaded from its file."""

from pathlib import Path

from perfbench.harness import reader

read = reader("engine.upload_bytes", Path(__file__).resolve().parents[2])
