"""Small sizes at which the harness runs on the CPU in its tests."""

import json

import torch

from perfbench import run


def tiny_mix(mix: dict) -> dict:
    return dict(mix, batch=2, size=64, distinct=2, warmup_calls=1,
                check_calls=2, reference_block=2)


def cell_parts(name: str):
    """-> (configuration, tiny mix) of a cell of BENCHMARK.json."""
    _, _, config, mix = run.cell_entries(run.load_benchmark(), name)
    return config, tiny_mix(mix)


def run_tiny(monkeypatch, capsys, name: str, seed: int = 2 ** 31 + 11,
             seconds: float = 0.3) -> dict:
    """``run.main`` of cell ``name`` on the CPU at the tiny sizes -> its
    result line."""
    torch.set_num_threads(4)
    orig = run.cell_entries

    def entries(bench, cell, root=run.ROOT):
        a, b, config, mix = orig(bench, cell, root)
        return a, b, config, tiny_mix(mix)

    monkeypatch.setattr(run, "cell_entries", entries)
    assert run.main(["--workload", name, "--seed", str(seed), "--seconds",
                     str(seconds), "--trace", "0", "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
