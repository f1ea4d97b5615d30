"""The port's remote judges and VLM judges against the JAX package's, on
the CPU, through one loopback server (``chip_smoke.JudgeFixture``).

The JAX clients post through ``requests``; the port's through its
``http.client`` session. Each client runs in turn against the same fixture
on the same uint8 images: the bodies the fixture receives must be bitwise
equal (JPEG / PNG bytes, pickles, JSON) and the results equal, through the
clients and through ``multi_score`` (``geneval`` with its accuracy
decompositions and ``only_strict``, ``deqa``, ``unifiedreward`` in both
protocols, ``qwenvl`` with an injected generator). The retry policy is held
to urllib3's ``Retry`` (its ``get_backoff_time`` after each failure, or the
``Retry-After`` of a 503 in any case) on 500s, 503s and refused
connections, with the sleep stubbed; the JAX package's own policy is not run
here (it would sleep). The port retries ``https://`` judges too, where the
JAX session does not (a recorded departure, pinned by a test).
"""

import socket
import sys

import numpy as np
import pytest

from adv_grpo_torch.cli.common import build_reward_context, resolve_config
from adv_grpo_torch.rewards import remote as t_remote
from adv_grpo_torch.rewards import vlm as t_vlm
from adv_grpo_torch.rewards.registry import RewardContext as TRewardContext
from adv_grpo_torch.rewards.registry import multi_score as t_multi_score
from adv_grpo_tpu.rewards import remote as j_remote
from adv_grpo_tpu.rewards import vlm as j_vlm
from adv_grpo_tpu.rewards.registry import RewardContext as JRewardContext
from adv_grpo_tpu.rewards.registry import multi_score as j_multi_score
from chip_smoke import JudgeFixture

PROMPTS = ["a flower", "a red bicycle", "a city at night", "a bowl of fruit", "Café 東京"]
META = [{"tag": "single_object"}, {"tag": "two_object"}, {"tag": "single_object"},
        {"tag": "counting"}, {"tag": "two_object"}]


def _u8(seed=0, n=5, hw=24):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)


def _images(seed=0, n=5, hw=24):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, hw, hw)).astype(np.float32)


def _bodies(judge, start):
    return sorted(body for _, _, body in judge.requests[start:])


def _both(judge, make_j, make_t, *args):
    """Each package's client on ``args``: (JAX result, port result), after
    checking the fixture got the same bodies from both."""
    n0 = len(judge.requests)
    want = make_j()(*args)
    n1 = len(judge.requests)
    got = make_t()(*args)
    assert len(judge.requests) - n1 == n1 - n0 > 0
    assert _bodies(judge, n1) == sorted(b for _, _, b in judge.requests[n0:n1])
    return want, got


@pytest.fixture(scope="module")
def judge():
    with JudgeFixture(fail=2) as j:
        yield j


@pytest.mark.parametrize("batch_size", [64, 2])
def test_pickle_clients_send_the_jax_bodies(judge, batch_size):
    u8 = _u8(1)
    for path, make in (("/deqa", "deqa_score_client"),
                       ("/unifiedreward", "unifiedreward_remote_client")):
        url = judge.url + path
        want, got = _both(judge, lambda: getattr(j_remote, make)(url, batch_size=batch_size),
                          lambda: getattr(t_remote, make)(url, batch_size=batch_size),
                          u8, PROMPTS)
        np.testing.assert_array_equal(got, want)
    for only_strict in (True, False):
        url = judge.url + "/geneval"
        want, got = _both(judge, lambda: j_remote.geneval_score_client(url, batch_size),
                          lambda: t_remote.geneval_score_client(url, batch_size),
                          u8, PROMPTS, META, only_strict)
        assert got == want


def test_sglang_client_sends_the_jax_bodies(judge):
    url = judge.url + "/v1"
    n0 = len(judge.requests)
    want, got = _both(judge, lambda: j_remote.unifiedreward_sglang_client(url),
                      lambda: t_remote.unifiedreward_sglang_client(url), _u8(2), PROMPTS)
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0.2) & (got <= 1.0)).all()
    heads = [h for _, h, _ in judge.requests[n0:]]
    assert all(h["Content-Type"] == "application/json" and h["Authorization"] == "Bearer flowgrpo"
               for h in heads)


def test_multi_score_remote_rewards_match_jax(judge):
    images = _images(3)
    names = {"geneval": 1.0, "deqa": 0.5, "unifiedreward": 0.25}
    for sglang in (False, True):
        ur = judge.url + ("/v1" if sglang else "/unifiedreward")
        jctx = JRewardContext(remote={
            "geneval": j_remote.geneval_score_client(judge.url + "/geneval"),
            "deqa": j_remote.deqa_score_client(judge.url + "/deqa"),
            "unifiedreward": (j_remote.unifiedreward_sglang_client(ur) if sglang
                              else j_remote.unifiedreward_remote_client(ur))})
        tctx = TRewardContext(remote={
            "geneval": t_remote.geneval_score_client(judge.url + "/geneval"),
            "deqa": t_remote.deqa_score_client(judge.url + "/deqa"),
            "unifiedreward": (t_remote.unifiedreward_sglang_client(ur) if sglang
                              else t_remote.unifiedreward_remote_client(ur))})
        for only_strict in (True, False):
            want, _ = j_multi_score(names, jctx)(images, PROMPTS, META, only_strict=only_strict)
            got, _ = t_multi_score(names, tctx)(images, PROMPTS, META, only_strict=only_strict)
            assert set(got) == set(want) and "single_object_strict_accuracy" in got
            for key in want:
                np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))


def test_context_builds_the_clients_from_the_environment(judge, monkeypatch):
    monkeypatch.setenv("GENEVAL_URL", judge.url + "/geneval")
    monkeypatch.setenv("DEQA_URL", judge.url + "/deqa")
    cfg = resolve_config("smoke_sd3_fast")
    images = _images(4)
    for ur in ("/unifiedreward", "/v1"):
        monkeypatch.setenv("UNIFIEDREWARD_URL", judge.url + ur)
        ctx = build_reward_context(cfg, {"geneval", "deqa", "unifiedreward"}, device="cpu")
        n0 = len(judge.requests)
        details, _ = t_multi_score({"geneval": 1, "deqa": 1, "unifiedreward": 1}, ctx)(
            images, PROMPTS, META)
        paths = {p for p, _, _ in judge.requests[n0:]}
        assert paths == {"/geneval", "/deqa", ur if ur != "/v1" else "/v1/chat/completions"}
        assert np.isfinite(details["avg"]).all()


def test_retry_follows_urllib3s_policy_with_the_sleep_stubbed(judge):
    """Two 500s then an answer; two 503s whose header is a lower-case
    ``retry-after: 1`` then an answer (header names are case-insensitive, as
    urllib3 reads them); then a refused connection until the retries are
    spent. The sleeps are urllib3's ``get_backoff_time`` after each failure
    (0, then backoff * 2^(n-1)), or its ``Retry-After``."""
    urllib3 = pytest.importorskip("urllib3")
    sleeps = []
    sess = t_remote.HTTPSession(max_retries=5, sleep=sleeps.append)
    got = t_remote.deqa_score_client(judge.url + "/flaky", session=sess)(_u8(5), PROMPTS)
    want = t_remote.deqa_score_client(judge.url + "/deqa", session=sess)(_u8(5), PROMPTS)
    np.testing.assert_array_equal(got, want)
    retry, expect = urllib3.util.Retry(total=5, backoff_factor=1, status_forcelist=[500],
                                       allowed_methods=False), []
    for _ in range(2):
        retry = retry.increment("POST", "/flaky", response=urllib3.HTTPResponse(status=500))
        expect.append(retry.get_backoff_time())
    assert sleeps == expect == [0.0, 2.0]

    sleeps.clear()
    got = t_remote.deqa_score_client(judge.url + "/busy", session=sess)(_u8(5), PROMPTS)
    np.testing.assert_array_equal(got, want)
    retry, expect = urllib3.util.Retry(total=5, backoff_factor=1, status_forcelist=[500],
                                       allowed_methods=False), []
    busy = urllib3.HTTPResponse(status=503, headers={"retry-after": "1"})
    for _ in range(2):
        assert retry.is_retry("POST", 503, has_retry_after=True)
        retry = retry.increment("POST", "/busy", response=busy)
        expect.append(retry.get_retry_after(busy))
    assert sleeps == expect == [1.0, 1.0]
    assert [p for p, _, _ in judge.requests].count("/busy") == 3

    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    sleeps.clear()
    sess = t_remote.HTTPSession(max_retries=8, backoff=1.0, sleep=sleeps.append)
    with pytest.raises(t_remote.HTTPError, match="8 retries spent"):
        sess.post(f"http://127.0.0.1:{port}/x", data=b"x", timeout=5)
    retry, expect = urllib3.util.Retry(total=8, backoff_factor=1, status_forcelist=[500],
                                       allowed_methods=False), []
    for _ in range(8):
        retry = retry.increment("POST", "/x", error=urllib3.exceptions.ConnectTimeoutError())
        expect.append(retry.get_backoff_time())
    assert sleeps == expect and max(sleeps) == 120.0


def test_https_judges_are_retried_unlike_the_jax_session():
    """A recorded departure: the port's session retries ``https://`` judges
    as ``http://`` ones, as the JAX module docstring says of every client;
    the JAX ``_session`` mounts its ``Retry`` on ``http://`` only, so there
    an ``https://`` judge gets ``requests``' default adapter, no retries.
    Pinned on a plain HTTP server spoken to over TLS: the handshake fails,
    and the port retries it until its retries are spent."""
    pytest.importorskip("requests")
    jsess = j_remote._session(max_retries=7)
    assert jsess.get_adapter("http://judge").max_retries.total == 7
    assert jsess.get_adapter("https://judge").max_retries.total == 0
    with JudgeFixture() as judge:
        sleeps = []
        sess = t_remote.HTTPSession(max_retries=3, sleep=sleeps.append)
        with pytest.raises(t_remote.HTTPError, match="3 retries spent"):
            sess.post(judge.url.replace("http://", "https://") + "/deqa", data=b"x",
                      timeout=5)
        assert sleeps == [0.0, 2.0, 4.0]


def test_status_500_until_the_retries_are_spent_raises():
    with JudgeFixture(fail=10) as judge:
        sess = t_remote.HTTPSession(max_retries=3, sleep=lambda s: None)
        with pytest.raises(t_remote.HTTPError, match="3 retries spent"):
            sess.post(judge.url + "/flaky", data=b"x")
        assert len(judge.requests) == 4
        resp = t_remote.HTTPSession(max_retries=0).post(judge.url + "/nope", data=b"x")
        assert resp.status_code == 404 and resp.content == b"not found"
        with pytest.raises(t_remote.HTTPError, match="404"):
            resp.raise_for_status()


def test_qwenvl_judge_matches_jax(monkeypatch):
    texts = ["<Score>4</Score>", "no score", "<Thought>x</Thought><Score> 2.5 </Score>",
             "<Score>9</Score>", "<Score>3.0</Score>"]

    def gen(images_u8, prompts):
        assert len(images_u8) == len(prompts)
        return texts[:len(prompts)]

    u8, images = _u8(6), _images(6)
    np.testing.assert_array_equal(t_vlm.QwenVLScorer(generate_fn=gen)(u8, PROMPTS),
                                  j_vlm.QwenVLScorer(generate_fn=gen)(u8, PROMPTS))
    names = {"qwenvl": 2.0}
    tj, jj = t_vlm.QwenVLScorer(generate_fn=gen), j_vlm.QwenVLScorer(generate_fn=gen)
    want, _ = j_multi_score(names, JRewardContext(remote={"qwenvl": lambda u, p, m=None: jj(u, p)}))(
        images, PROMPTS)
    got, _ = t_multi_score(names, TRewardContext(remote={"qwenvl": lambda u, p, m=None: tj(u, p)}))(
        images, PROMPTS)
    np.testing.assert_array_equal(got["avg"], want["avg"])
    with pytest.raises(RuntimeError, match="model_dir"):
        t_vlm.QwenVLScorer()
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="'transformers'"):
        t_vlm.QwenVLScorer(model_dir="/nonexistent")
