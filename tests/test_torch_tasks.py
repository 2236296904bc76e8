"""The port's canned task launchers (``python -m controllora_tpu_torch.tasks``)
against the JAX package's ``tasks/*.py``.

For each of the 14 launchers, the port runs the same CLI (``scripts/<cli>.py`` ->
``controllora_tpu_torch.<cli>``) with the JAX launcher's argument list, element for
element (captured as ``tests/test_tasks_launchers.py`` captures it), and that list
parses under the port CLI's ``parse_args``; the user's arguments go last.
"""

import sys

import pytest

from controllora_tpu_torch import mix_lora, sample, tasks, train, train_dreambooth
from test_tasks_launchers import LAUNCHERS, _capture_launch

PARSERS = {"train": train.parse_args, "sample": sample.parse_args,
           "train_dreambooth": train_dreambooth.parse_args, "mix_lora": mix_lora.parse_args}


def test_the_same_fourteen_tasks():
    assert sorted(tasks.TASKS) == sorted(f[:-3] for f in LAUNCHERS)
    assert len(tasks.TASKS) == 14


@pytest.mark.parametrize("task_file", LAUNCHERS)
def test_task_argv_equals_jax_launcher(task_file):
    script, args = _capture_launch(task_file)
    cli, ours = tasks.TASKS[task_file[:-3]]
    assert f"{cli}.py" == script
    assert ours == args
    ns = PARSERS[cli](ours)  # SystemExit(2) here = a flag the port does not take
    assert ns is not None
    cmd = tasks.command(task_file[:-3], ["--seed", "7"])
    assert cmd == [sys.executable, "-m", f"controllora_tpu_torch.{cli}", *args, "--seed", "7"]
    assert PARSERS[cli](cmd[3:]).seed == 7  # the user's flag, last, wins


def test_main_runs_the_command(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(tasks.subprocess, "call", lambda cmd: calls.append(cmd) or 3)
    assert tasks.main(["test_canny", "--num_validation_images", "1"]) == 3
    assert calls == [tasks.command("test_canny", ["--num_validation_images", "1"])]
    assert capsys.readouterr().out.startswith("+ ")
    assert tasks.main(["--list"]) == 0 and "train_canny" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown task"):
        tasks.main(["train_nothing"])
