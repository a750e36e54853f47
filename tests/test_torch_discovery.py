"""The port's data discovery and token pipeline against the JAX package.

* ``tokenize_trajectory``, ``TokenPipeline`` batches and a pipeline resumed
  from its saved state: exactly equal to the JAX package's, and the
  synthetic corpus too.
* ``curate`` on ``trajectory_repository(32, seed=0)``: the same selection,
  the same count deduplicated away and the same search counters as the JAX
  package's ``curate`` (each builds its own repository from the lake).
* ``examples/quickstart_torch.py --device cpu`` runs to its end.
"""
import runpy
from pathlib import Path

import numpy as np
import pytest

from repro.data import discovery as jdiscovery
from repro.data import synthetic as jsynthetic
from repro.data import tokens as jtokens
from repro_torch.data import discovery, synthetic, tokens
from torch_lm_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
THETA = 5


@pytest.fixture(scope="module")
def lake():
    datasets = synthetic.trajectory_repository(32, seed=0)
    for a, b in zip(datasets, jsynthetic.trajectory_repository(32, seed=0)):
        np.testing.assert_array_equal(a, b)
    return datasets


@pytest.fixture(scope="module")
def curated(lake):
    """Both packages' curation for each metric, k = 12, theta 5."""
    out = {}
    for metric in ("hausdorff", "gbo"):
        out[metric] = (
            discovery.curate(lake, lake[0], k=12, theta=THETA, metric=metric,
                             device="cpu"),
            jdiscovery.curate(lake, lake[0], k=12, theta=THETA,
                              metric=metric))
    return out


@pytest.mark.parametrize("metric", ["hausdorff", "gbo"])
def test_curate_matches_jax(curated, metric):
    (kept, repo, info), (jkept, jrepo, jinfo) = curated[metric]
    assert kept == jkept
    assert kept[0] == 0                         # the exemplar itself
    assert info["deduped_away"] == jinfo["deduped_away"]
    assert len(kept) + info["deduped_away"] == 12
    if metric == "hausdorff":
        assert info["search_stats"] == jinfo["search_stats"]
    assert repo.device.type == "cpu"


def test_tokenize_trajectory_matches_jax(lake, curated):
    _, repo, _ = curated["hausdorff"][0]
    jrepo = curated["hausdorff"][1][1]
    for i in (0, 5, 31):
        for theta in (3, THETA, 8):
            got = tokens.tokenize_trajectory(lake[i], repo.space_lo,
                                             repo.space_hi, theta)
            want = jtokens.tokenize_trajectory(lake[i], jrepo.space_lo,
                                               jrepo.space_hi, theta)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            assert got[0] == tokens.BOS and got[-1] == tokens.EOS
            assert (got[1:-1] >= tokens.SPECIALS).all()


def test_token_pipeline_batches_and_resume_match_jax(lake, curated):
    """Both pipelines over the port's documents (the tokenization is held
    to the JAX package's by the test above)."""
    kept, repo, _ = curated["hausdorff"][0]
    pipe = discovery.pipeline_from_selection(lake, kept, repo, theta=THETA,
                                             seq_len=32, batch=4, seed=3)
    assert len(pipe.docs) == len(kept)
    jpipe = jtokens.TokenPipeline(pipe.docs, 32, 4, seed=3)
    for _ in range(5):
        got, want = pipe.next_batch(), jpipe.next_batch()
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])
    # a pipeline resumed from the saved state continues where it stood
    state = pipe.state.as_dict()
    assert state == jpipe.state.as_dict()
    resumed = tokens.TokenPipeline(
        pipe.docs, 32, 4, seed=3, state=tokens.PipelineState.from_dict(state))
    jresumed = jtokens.TokenPipeline(
        jpipe.docs, 32, 4, seed=3,
        state=jtokens.PipelineState.from_dict(state))
    for _ in range(3):
        got, want = resumed.next_batch(), jresumed.next_batch()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["tokens"],
                                      pipe.next_batch()["tokens"])
    assert resumed.state.as_dict() == jresumed.state.as_dict()
    # the synthetic corpus is the JAX package's, document by document
    for a, b in zip(tokens.synthetic_corpus(6, 500, seed=2),
                    jtokens.synthetic_corpus(6, 500, seed=2)):
        np.testing.assert_array_equal(a, b)


def test_quickstart_torch_runs_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["quickstart_torch.py", "--device",
                                     "cpu"])
    runpy.run_path(str(REPO / "examples" / "quickstart_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [
        "unified index", "RangeS", "IA    top-5", "GBO   top-5",
        "Haus  top-5", "ApproHaus top-5", "RangeP", "NNP"]
    assert out[4].startswith("Haus  top-5: [7, ")    # the exemplar first
