"""The remote reward judges' clients, on the standard library alone.

Port of adv_grpo_tpu/rewards/remote.py: the same wire formats as the
reference's reward servers (adv_grpo/rewards.py:761-1010), so existing
deployments work unchanged:

  * GenEval object-detection judge: a pickled ``{"images": [jpeg bytes],
    "meta_datas": [...], "only_strict": bool}`` POST; the response carries
    ``scores / rewards / strict_rewards / group_rewards /
    group_strict_rewards`` (rewards.py:812-881);
  * DeQA quality judge: a pickled ``{"images": [jpeg bytes]}`` POST, the
    response ``{"outputs": [...]}`` (:761-808);
  * UnifiedReward, pickle flavour: ``{"images": ..., "prompts": ...}``
    (:884-940);
  * UnifiedReward, sglang flavour: OpenAI-compatible ``/chat/completions``
    with a base64 PNG and the verbatim rubric, the ``Final Score: X`` regex,
    scores over 5 (:942-1010).

``jpeg_bytes``, ``png_base64``, ``extract_final_scores`` and the rubric are
copies of the JAX package's (tests/test_torch_copies.py holds them equal).
The JAX clients post through ``requests``; the card's machine need not
have it, so :class:`HTTPSession` posts through ``http.client`` with the
JAX ``_session``'s retry policy (urllib3's ``Retry(total=max_retries,
backoff_factor=1, status_forcelist=[500], allowed_methods=False)``): a
status 500 (and a 413 / 429 / 503 that carries ``Retry-After``) and a
connection or read error are retried, for POST too, up to ``max_retries``
times; before the n-th retry of a run of failures it sleeps the response's
``Retry-After`` (its name in any case) where it has one, else 0 for n = 1
and ``backoff · 2^(n-1)`` s, at most 120 s, after
(``Retry.get_backoff_time``). Then it raises. The policy holds for
``https://`` judges too, as the JAX module docstring says of every client;
the JAX ``_session`` mounts it on ``http://`` only (:60), so there an
``https://`` judge gets ``requests``' default of no retries. The body goes out as given (``data=``) or as ``requests`` writes a
``json=`` body (``json.dumps(allow_nan=False)``, UTF-8), so a judge
receives the JAX clients' bytes. Images arrive as (N, H, W, 3) uint8 (the
registry's host copy).
"""

from __future__ import annotations

import email.utils
import http.client
import io
import json as jsonlib
import re
import time
import urllib.parse
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np

GENEVAL_URL = "http://127.0.0.1:18085"
DEQA_URL = "http://127.0.0.1:18086"
UNIFIEDREWARD_SGLANG_URL = "http://127.0.0.1:17140/v1"

# verbatim reference judge rubric (rewards.py:986 evaluate_image)
UNIFIEDREWARD_QUESTION = (
    "<image>\nYou are given a text caption and a generated image based on that "
    "caption. Your task is to evaluate this image based on two key criteria:\n"
    "1. Alignment with the Caption: Assess how well this image aligns with the "
    "provided caption. Consider the accuracy of depicted objects, their "
    "relationships, and attributes as described in the caption.\n"
    "2. Overall Image Quality: Examine the visual quality of this image, "
    "including clarity, detail preservation, color accuracy, and overall "
    "aesthetic appeal.\nBased on the above criteria, assign a score from 1 to "
    "5 after 'Final Score:'.\nYour task is provided as follows:\nText Caption: "
    "[{prompt}]"
)

_FINAL_SCORE_RE = re.compile(r"Final Score:\s*([1-5](?:\.\d+)?)")
BACKOFF_MAX = 120.0  # urllib3's Retry.DEFAULT_BACKOFF_MAX
RETRY_AFTER_STATUS = (413, 429, 503)  # urllib3's Retry.RETRY_AFTER_STATUS_CODES


class HTTPError(RuntimeError):
    """A status of 400 or more (``raise_for_status``), or the retries spent."""


class Response:
    """What :meth:`HTTPSession.post` returns: ``status_code``, ``headers``,
    ``content`` (bytes), ``json()`` and ``raise_for_status()``."""

    def __init__(self, url: str, status_code: int, headers: Mapping[str, str],
                 content: bytes):
        self.url, self.status_code, self.headers, self.content = (url, status_code, headers,
                                                                  content)

    def json(self):
        return jsonlib.loads(self.content)

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise HTTPError(f"{self.status_code} error for url: {self.url}")


def _retry_after(value: Optional[str]) -> Optional[float]:
    """urllib3's ``Retry.parse_retry_after``: seconds, or an HTTP date."""
    if value is None:
        return None
    if re.fullmatch(r"\s*[0-9]+\s*", value):
        return float(int(value))
    parsed = email.utils.parsedate_tz(value)
    if parsed is None:
        raise HTTPError(f"invalid Retry-After header: {value}")
    return max(0.0, email.utils.mktime_tz(parsed) - time.time())


class HTTPSession:
    """``post(url, data=| json=, timeout=, headers=) -> Response`` over
    ``http.client``, with the retry policy of the module docstring.
    ``sleep`` is the pause between attempts (``time.sleep``; tests pass a
    stub)."""

    def __init__(self, max_retries: int = 1000, backoff: float = 1.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.max_retries, self.backoff, self.sleep = max_retries, backoff, sleep

    def _send(self, url: str, body: bytes, headers: Dict[str, str], timeout) -> Response:
        parts = urllib.parse.urlsplit(url)
        conn_cls = (http.client.HTTPSConnection if parts.scheme == "https"
                    else http.client.HTTPConnection)
        conn = conn_cls(parts.hostname, parts.port, timeout=timeout)
        try:
            path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            # resp.msg looks header names up case-insensitively, as requests does
            return Response(url, resp.status, resp.msg, resp.read())
        finally:
            conn.close()

    def post(self, url: str, data: Optional[bytes] = None, json=None, timeout=None,
             headers: Optional[Dict[str, str]] = None) -> Response:
        hdrs = dict(headers or {})
        body = data
        if not data and json is not None:
            body = jsonlib.dumps(json, allow_nan=False).encode("utf-8")
            hdrs["Content-Type"] = "application/json"
        body = body or b""
        failures = 0
        while True:
            try:
                resp = self._send(url, body, hdrs, timeout)
                wait = _retry_after(resp.headers.get("Retry-After"))
                if not (resp.status_code == 500 or (resp.status_code in RETRY_AFTER_STATUS
                                                    and wait is not None)):
                    return resp
                error: Exception = HTTPError(f"{resp.status_code} from {url}")
            except (OSError, http.client.HTTPException) as exc:
                error, wait = exc, None
            failures += 1
            if failures > self.max_retries:
                raise HTTPError(f"{url}: {self.max_retries} retries spent; last: "
                                f"{error!r}") from error
            if not wait:
                wait = (0.0 if failures <= 1
                        else min(BACKOFF_MAX, self.backoff * 2 ** (failures - 1)))
            self.sleep(wait)


def jpeg_bytes(images_u8: np.ndarray) -> List[bytes]:
    from PIL import Image

    out = []
    for arr in images_u8:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG")
        out.append(buf.getvalue())
    return out


def png_base64(image_u8: np.ndarray, resize: Optional[int] = 512) -> str:
    import base64

    from PIL import Image

    img = Image.fromarray(image_u8)
    if resize:
        img = img.resize((resize, resize))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image;base64," + base64.b64encode(buf.getvalue()).decode()


def extract_final_scores(text_outputs: List[str]) -> List[float]:
    """'Final Score: X' regex extraction, 0.0 on miss (rewards.py:955-967)."""
    scores = []
    for text in text_outputs:
        m = _FINAL_SCORE_RE.search(text or "")
        if m:
            try:
                scores.append(float(m.group(1)))
                continue
            except ValueError:
                pass
        scores.append(0.0)
    return scores


def geneval_score_client(url: str = GENEVAL_URL, batch_size: int = 64,
                         session=None, timeout: float = 120.0):
    """GenEval client (reference rewards.py:812-881). Returns
    fn(images_u8, prompts, metadatas, only_strict) ->
    (scores, rewards, strict_rewards, group_rewards, group_strict_rewards)."""
    import pickle

    sess = session or HTTPSession()

    def _fn(images_u8, prompts, metadatas, only_strict: bool = True):
        del prompts  # the judge reads metadata, not raw prompts (:829)
        n = len(images_u8)
        n_batches = int(np.ceil(n / batch_size))
        idx_batches = np.array_split(np.arange(n), n_batches)
        all_scores, all_rewards, all_strict = [], [], []
        group_rewards, group_strict = {}, {}
        for idx in idx_batches:
            data = {
                "images": jpeg_bytes(images_u8[idx]),
                "meta_datas": [metadatas[i] for i in idx],
                "only_strict": only_strict,
            }
            resp = sess.post(url, data=pickle.dumps(data), timeout=timeout)
            resp.raise_for_status()  # 502/404 bodies are not pickles
            rd = pickle.loads(resp.content)
            all_scores += list(rd["scores"])
            all_rewards += list(rd["rewards"])
            all_strict += list(rd["strict_rewards"])
            for key, value in rd["group_strict_rewards"].items():
                group_strict.setdefault(key, []).extend(value)
            for key, value in rd["group_rewards"].items():
                group_rewards.setdefault(key, []).extend(value)
        return all_scores, all_rewards, all_strict, group_rewards, group_strict

    return _fn


def deqa_score_client(url: str = DEQA_URL, batch_size: int = 64,
                      session=None, timeout: float = 120.0):
    """DeQA quality judge (reference rewards.py:761-808):
    fn(images_u8, prompts, metadata) -> np.ndarray scores."""
    import pickle

    sess = session or HTTPSession()

    def _fn(images_u8, prompts, metadata=None):
        del prompts, metadata
        n_batches = int(np.ceil(len(images_u8) / batch_size))
        all_scores = []
        for chunk in np.array_split(np.arange(len(images_u8)), n_batches):
            data = {"images": jpeg_bytes(images_u8[chunk])}
            resp = sess.post(url, data=pickle.dumps(data), timeout=timeout)
            resp.raise_for_status()  # 502/404 bodies are not pickles
            all_scores += list(pickle.loads(resp.content)["outputs"])
        return np.asarray(all_scores, np.float64)

    return _fn


def unifiedreward_remote_client(url: str, batch_size: int = 64, session=None,
                                timeout: float = 120.0):
    """Pickle-protocol UnifiedReward server (reference rewards.py:884-940)."""
    import pickle

    sess = session or HTTPSession()

    def _fn(images_u8, prompts, metadata=None):
        del metadata
        n = len(images_u8)
        n_batches = int(np.ceil(n / batch_size))
        all_scores = []
        for chunk in np.array_split(np.arange(n), n_batches):
            data = {"images": jpeg_bytes(images_u8[chunk]),
                    "prompts": [prompts[i] for i in chunk]}
            resp = sess.post(url, data=pickle.dumps(data), timeout=timeout)
            resp.raise_for_status()  # 502/404 bodies are not pickles
            all_scores += list(pickle.loads(resp.content)["outputs"])
        return np.asarray(all_scores, np.float64)

    return _fn


def unifiedreward_sglang_client(base_url: str = UNIFIEDREWARD_SGLANG_URL,
                                model: str = "UnifiedReward-7b-v1.5",
                                api_key: str = "flowgrpo", session=None,
                                timeout: float = 300.0):
    """OpenAI-compatible sglang judge (reference rewards.py:942-1010): one
    ``/chat/completions`` request per image, 8 in flight (the reference
    async-gathers); scores over 5."""
    sess = session or HTTPSession(max_retries=3)
    url = base_url.rstrip("/") + "/chat/completions"

    def _judge_one(prompt: str, image_u8: np.ndarray) -> str:
        body = {
            "model": model,
            "temperature": 0,
            "messages": [{
                "role": "user",
                "content": [
                    {"type": "image_url",
                     "image_url": {"url": png_base64(image_u8)}},
                    {"type": "text",
                     "text": UNIFIEDREWARD_QUESTION.format(prompt=prompt)},
                ],
            }],
        }
        resp = sess.post(url, json=body, timeout=timeout,
                         headers={"Authorization": f"Bearer {api_key}"})
        resp.raise_for_status()
        payload = resp.json()
        if "choices" not in payload:  # error body from a proxy/warming judge
            raise RuntimeError(f"sglang judge returned no choices: "
                               f"{str(payload)[:200]}")
        return payload["choices"][0]["message"]["content"]

    def _fn(images_u8, prompts, metadata=None):
        del metadata
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=8) as pool:
            texts = list(pool.map(_judge_one, prompts, list(images_u8)))
        scores = extract_final_scores(texts)
        return np.asarray([s / 5.0 for s in scores], np.float64)

    return _fn
