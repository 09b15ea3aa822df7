"""The port's multi-pair runtime against the JAX package's under the hex
pyramid's axes (BASELINE config #4: res 7/8/9 x 5 min): the checks and
bars of ``test_torch_pipelines.py``, which holds the multi-window's."""

import pytest

from test_torch_pipelines import (check_each_pair_equals_its_one_pair_run,
                                  check_jax_commit_resumed_by_the_port,
                                  check_port_commit_resumed_by_jax,
                                  check_runtime_matches_jax)


@pytest.mark.parametrize("pinned", [False, True], ids=["defaults", "pinned"])
def test_hex_pyramid_runtime_matches_jax(tmp_path, tmp_path_factory,
                                         monkeypatch, pinned):
    check_runtime_matches_jax(tmp_path, tmp_path_factory, monkeypatch,
                              "pyramid", pinned)


def test_hex_pyramid_pairs_equal_their_one_pair_runs(tmp_path, monkeypatch):
    check_each_pair_equals_its_one_pair_run(tmp_path, monkeypatch,
                                            "pyramid")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hex_pyramid_commit_resumes_across_packages(
        tmp_path, tmp_path_factory, monkeypatch, writer):
    check = (check_jax_commit_resumed_by_the_port if writer == "jax"
             else check_port_commit_resumed_by_jax)
    check(tmp_path, tmp_path_factory, monkeypatch, "pyramid")
