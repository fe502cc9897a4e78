"""The port's public API (``gpu_bpe_tpu_torch.api``, ``BPETokenizer``) on the
CPU against the JAX package's, bitwise (tolerance 0 everywhere): merge
lists and counts of ``api.train`` (port ``device="cpu"`` against JAX
``backend="tpu"`` on the JAX CPU, port ``backend="cpu"`` against JAX
``backend="cpu"``), with and without pre-tokenization and dedup; the model
JSON, trie and DXFT bytes; token ids of ``encode`` (merge order) and
``encode_bulk`` (greedy)."""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from gpu_bpe_tpu import api as japi  # noqa: E402
from gpu_bpe_tpu.core.model_io import read_dxft as jax_read_dxft  # noqa: E402
from gpu_bpe_tpu_torch import api  # noqa: E402
from gpu_bpe_tpu_torch.core import BPEModel, read_dxft  # noqa: E402
from gpu_bpe_tpu_torch.models import BPETokenizer  # noqa: E402
from gpu_bpe_tpu_torch.trie import parse_trie  # noqa: E402

VOCAB = 256 + 60


@pytest.fixture(scope="module")
def corpus(english_text):
    return (english_text[:6000] + "\nCafé étude Å 12345678 don’t\n").encode()


def _cfg(mod, **kw):
    return mod.TrainConfig(vocab_size=VOCAB, show_progress=False, **kw)


def _same(a, b):
    assert a.merges == b.merges and a.merge_counts == b.merge_counts
    assert a.vocab == b.vocab and a.vocab_size == b.vocab_size


@pytest.mark.parametrize("pre_tokenize,dedup", [(True, True), (True, False), (False, True)])
def test_train_matches_jax(corpus, pre_tokenize, dedup):
    kw = dict(pre_tokenize=pre_tokenize, dedup=dedup)
    jt, jr = japi.train(corpus, _cfg(japi, backend="tpu", **kw))
    tt, tr = api.train(corpus, _cfg(api, device="cpu", **kw))
    _same(tr, jr)
    assert len(tr.merges) == VOCAB - 256
    jc, jcr = japi.train(corpus, _cfg(japi, backend="cpu", **kw))
    tc, tcr = api.train(corpus, _cfg(api, backend="cpu", **kw))
    _same(tcr, jcr)
    _same(tcr, tr)
    assert tt.backend == "cuda" and tt.device == "cpu" and tc.backend == "cpu"
    assert tt.model.to_json() == jt.model.to_json() == tc.model.to_json()


@pytest.fixture(scope="module")
def models(corpus):
    jt, _ = japi.train(corpus, _cfg(japi, backend="cpu"))
    tt, _ = api.train(corpus, _cfg(api, device="cpu"))
    return jt, tt


def test_artifacts_match_jax(models, corpus, tmp_path):
    jt, tt = models
    assert tt.model.to_json() == jt.model.to_json()
    assert api.export_trie(tt, str(tmp_path / "t.bin")) == japi.export_trie(jt)
    assert (tmp_path / "t.bin").read_bytes() == jt.compile_trie()
    trie = parse_trie(tt.compile_trie())
    assert trie.vocab_size == VOCAB and trie.max_token_len == max(len(v) for v in tt.model.vocab)
    blob = api.export_bin(tt, corpus, str(tmp_path / "c.bin"))
    assert blob == jt.export_bin(corpus) == (tmp_path / "c.bin").read_bytes()
    toks, model, head = read_dxft(blob)
    jtoks, jmodel, jhead = jax_read_dxft(blob)
    np.testing.assert_array_equal(toks, jtoks)
    assert model.to_json() == jmodel.to_json() and head == jhead == {"vocabSize": VOCAB, "tokenCount": len(toks)}
    assert tt.export_vocab_text() == jt.export_vocab_text()
    with pytest.raises(ValueError, match="magic"):
        read_dxft(b"XXXX" + blob[4:])


def test_encode_and_encode_bulk_match_jax(models, corpus):
    jt, tt = models
    text = corpus.decode() + " unseen wörds ﬁle"
    assert api.encode(tt, text) == japi.encode(jt, text)
    bulk = api.encode_bulk(tt, corpus)
    np.testing.assert_array_equal(bulk, japi.encode_bulk(jt, corpus))  # JAX backend "cpu": GreedyTrieEncoder
    jax_dev = japi.BPETokenizer(jt.model, backend="tpu")  # TPUTokenizer on the JAX CPU
    np.testing.assert_array_equal(bulk, jax_dev.encode_bytes_greedy(corpus))
    np.testing.assert_array_equal(bulk, BPETokenizer(tt.model, backend="cpu").encode_bytes_greedy(corpus))
    assert api.decode(tt, bulk) == japi.decode(jt, bulk) == corpus.decode()
    assert tt.decode([0x10000, 65]) == b"\xef\xbf\xbdA"


def test_save_load_roundtrip(models, tmp_path):
    jt, tt = models
    path = tmp_path / "m.json"
    tt.save(str(path))
    assert path.read_text() == jt.model.to_json()
    loaded = api.load_model(str(path), device="cpu")
    assert loaded.model.merges == tt.model.merges and loaded.model.vocab == tt.model.vocab
    assert loaded.model.byte_ids is None and loaded.backend == "cuda"
    assert BPETokenizer.from_json(path.read_bytes(), backend="cpu").compile_trie() == tt.compile_trie()
    # a vocab whose single-byte tokens are not at ids 0-255
    odd = BPEModel(vocab=[b"ab"] + [bytes([i]) for i in range(256)], merges=[(98, 99, 257)])
    assert odd.byte_ids[97] == 98
    jodd = japi.BPETokenizer.from_json(odd.to_json(), backend="cpu")
    assert BPETokenizer(odd, backend="cpu").encode("abcab") == jodd.encode("abcab")


def test_unported_paths_raise(models, corpus):
    """The Hugging Face export and import equal the JAX package's; the TPU
    backend is not the port's and raises."""
    jt, tt = models
    for pretok in ("none", "byte-level"):
        hf = tt.export_hf_json(pretok=pretok)
        assert hf == jt.export_hf_json(pretok=pretok)
        back, jback = BPEModel.from_json(hf), japi.BPETokenizer.from_json(hf, backend="cpu").model
        assert back.vocab == tt.model.vocab == jback.vocab and back.merges == jback.merges
    with pytest.raises(ValueError):
        api.train(corpus, _cfg(api, backend="tpu"))
    with pytest.raises(ValueError):
        BPETokenizer(tt.model, backend="tpu")


def test_cuda_default_requires_a_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.train(corpus, _cfg(api))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.train(corpus, _cfg(api, backend="dist"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BPETokenizer(BPEModel(vocab=[bytes([i]) for i in range(256)], merges=[])).encode_bytes_greedy(corpus)


def test_corpus_files_and_progress(tmp_path):
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "b.txt").write_bytes(b"banana bandana")
    (tmp_path / "d" / "a.md").write_bytes(b"ananas cabana")
    (tmp_path / "d" / "skip.bin").write_bytes(b"\x00")
    (tmp_path / "c.dat").write_bytes(b"named")
    paths = [str(tmp_path / "d"), str(tmp_path / "c.dat")]
    assert api.collect_files(paths) == japi.collect_files(paths)
    files = [b"p1\n\np2", b"p3", b"p4\n\np5"]
    for shuffle in (False, True):
        assert api.build_corpus(files, shuffle, seed=3) == japi.build_corpus(files, shuffle, seed=3)
    files = [b"the cat sat\n\non the mat", b"the hat\n\nthe cat ran to the hat"] * 20
    events = []
    tok, res = api.train(files, api.TrainConfig(vocab_size=270, device="cpu", shuffle=True),
                         on_progress=events.append)
    jtok, jres = japi.train(files, japi.TrainConfig(vocab_size=270, backend="cpu", shuffle=True,
                                                         show_progress=False))
    _same(res, jres)
    assert len(res.merges) > 5 and events[-1]["mergeIndex"] == len(res.merges)


def test_profile_dir_writes_a_trace(corpus, tmp_path):
    """The trace names the program's spans beside the torch ops; tracing is
    off again afterwards, as it was, and the job's spans are gone."""
    from gpu_bpe_tpu_torch.utils import timing

    assert not timing._on and timing.spans() == []
    api.train(corpus[:2000], api.TrainConfig(vocab_size=270, device="cpu", show_progress=False,
                                             profile_dir=str(tmp_path / "prof")))
    files = [p for p in (tmp_path / "prof").iterdir() if p.name.endswith(".json")]
    assert files
    names = {e.get("name") for p in files for e in json.loads(p.read_text())["traceEvents"]}
    assert {"train.job", "train.pretokenize", "train.dedup", "train.upload", "train.batch", "train.read",
            "train.recount", "train.build"} <= names
    assert not timing._on and timing.spans() == []
