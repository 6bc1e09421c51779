"""``engine.graph_replay_share`` in the stream cell, where the engine's
forward moves ``latency_p99_ms``: the same reader, loaded from its file."""

from pathlib import Path

from perfbench.harness import reader

read = reader("engine.graph_replay_share", Path(__file__).resolve().parents[2])
