"""Streamed ingest of the port (native library, StreamAccumulator,
make_stream_chunked, stream_paths, api.train_files) against its numpy path
and the JAX package, on the CPU.

Tolerance 0: streams are compared bit for bit (symbols, weights, n,
total_bytes) and merge lists exactly.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from gpu_bpe_tpu import api as japi  # noqa: E402
from gpu_bpe_tpu.ops import ingest as jingest  # noqa: E402
from gpu_bpe_tpu_torch import api  # noqa: E402
from gpu_bpe_tpu_torch.ops import ingest, native  # noqa: E402
from gpu_bpe_tpu_torch.pretok import PreTokenizer  # noqa: E402

UNICODE_TEXT = ("café naïve étude " * 100 + "中文分词 tests " * 50).encode()


@pytest.fixture
def numpy_path(monkeypatch):
    """Run the port's dedup on its numpy path (as on a host without g++)."""
    monkeypatch.setattr(native, "native_dedup", lambda *a: None)
    monkeypatch.setattr(native, "native_available", lambda: False)


def _assert_equal(a, b):
    assert a.n == b.n and a.total_bytes == b.total_bytes
    np.testing.assert_array_equal(np.asarray(a.symbols[: a.n], np.uint32), np.asarray(b.symbols[: b.n], np.uint32))
    np.testing.assert_array_equal(np.asarray(a.weights[: a.n]), np.asarray(b.weights[: b.n]))


def _mask_256():
    s = np.zeros(8, np.int64)
    s[4] = 256  # truthy, but 256 & 0xFF == 0: must stay a word start
    return b"abcdefgh", s


def _dedup_cases():
    rng = np.random.default_rng(17)
    w = b"abcdefghijklmnopqrstuvwxyz0123456789" * 3
    d2 = b"the " * 2000 + w * 50 + b"a" * 500
    s2 = np.zeros(len(d2), np.uint8)
    s2[::4] = 1
    return {
        "random": (rng.integers(97, 123, size=80000, dtype=np.uint8).tobytes(),
                   (rng.random(80000) < 0.2).astype(np.uint8)),
        "long_words": (d2, s2),
        "single_word": (b"hello", np.zeros(5, np.uint8)),
        "one_byte_words": (b"abcabc", np.ones(6, np.uint8)),
        "mask_256": _mask_256(),
    }


def test_native_library_builds():
    assert native.native_available()
    from gpu_bpe_tpu_torch.utils.build import BUILD_DIR

    path = native.LIBRARY.path()
    assert path.parent == BUILD_DIR and path.name.startswith("libingest-") and path.exists()
    assert native._raw_lib()._name == str(path)


@pytest.mark.parametrize("case", sorted(_dedup_cases()))
def test_make_stream_native_numpy_and_jax(case, monkeypatch):
    data, starts = _dedup_cases()[case]
    nat = ingest.make_stream(data, starts, dedup=True)
    _assert_equal(nat, jingest.make_stream(data, starts, dedup=True))
    with monkeypatch.context() as m:
        m.setattr(native, "native_dedup", lambda *a: None)
        _assert_equal(nat, ingest.make_stream(data, starts, dedup=True))
    bytes_arr = np.frombuffer(data, np.uint8)
    mask = np.asarray(starts) != 0
    mask[0] = True
    _assert_equal(nat, ingest.numpy_dedup(bytes_arr, mask))


@pytest.mark.parametrize("case", ["random", "mask_256", "one_byte_words"])
def test_accumulator_native_numpy_and_jax(case, monkeypatch):
    rng = np.random.default_rng(19)
    chunks = [(rng.integers(97, 106, size=30000, dtype=np.uint8).tobytes(),
               (rng.random(30000) < 0.3).astype(np.uint8)) for _ in range(4)]
    chunks.insert(2, _dedup_cases()[case])

    def run(cls):
        acc = cls()
        for d, s in chunks:
            acc.add_chunk(d, s)
        return acc.finish()

    got = run(ingest.StreamAccumulator)
    _assert_equal(got, run(jingest.StreamAccumulator))
    with monkeypatch.context() as m:
        m.setattr(native, "native_available", lambda: False)
        _assert_equal(got, run(ingest.StreamAccumulator))
    # chunked == monolithic on the concatenation (each chunk's first
    # position starts a word, as add_chunk makes it)
    alls = np.concatenate([np.asarray(s) != 0 for _, s in chunks])
    np.put(alls, np.cumsum([0] + [len(d) for d, _ in chunks[:-1]]), True)
    _assert_equal(got, ingest.make_stream(b"".join(d for d, _ in chunks), alls, dedup=True))


def test_overflow_guard(monkeypatch):
    """rc -2 of the library (a word frequency past int32) raises
    AssertionError, as the numpy path's assert does."""
    import ctypes

    lib = native._raw_lib()
    h = lib.ingest_acc_new()
    data = (ctypes.c_uint8 * 2)(97, 98)
    starts = (ctypes.c_uint8 * 2)(1, 0)
    assert lib.ingest_acc_add(h, data, starts, 2) == 0
    lib.ingest_acc_free(h)
    monkeypatch.setattr(native, "_lib", lambda: lambda *a: -2)
    with pytest.raises(AssertionError, match="overflows int32"):
        native.native_dedup(np.frombuffer(b"ab", np.uint8), np.array([1, 0], bool), 1 << 16)


def _chunked(mod, corpus: bytes, chunk: int):
    return mod.make_stream_chunked(iter([corpus[i : i + chunk] for i in range(0, len(corpus), chunk)]))


@pytest.mark.parametrize("text,chunk", [("english", 256), ("english", 1023), ("english", 4096),
                                        ("unicode", 7), ("unicode", 33), ("unicode", 101)])
def test_chunked_equals_monolithic_and_jax(english_text, text, chunk):
    corpus = english_text[:20000].encode() if text == "english" else UNICODE_TEXT
    data, starts = PreTokenizer().pre_tokenize_bytes(corpus)
    ref = ingest.make_stream(data, starts, dedup=True)
    got = _chunked(ingest, corpus, chunk)
    _assert_equal(got, ref)
    _assert_equal(got, _chunked(jingest, corpus, chunk))


def test_chunked_numpy_path(english_text, numpy_path):
    corpus = english_text[:8000].encode()
    _assert_equal(_chunked(ingest, corpus, 1023), _chunked(jingest, corpus, 1023))


def test_stream_paths_separators(tmp_path):
    files = [b"hello world " * 40, b"", "goodbye moon éé ".encode() * 40, b"x"]
    paths = []
    for i, blob in enumerate(files):
        p = tmp_path / f"{i}.txt"
        p.write_bytes(blob)
        paths.append(str(p))
    for chunk in (3, 64, 1 << 20):
        got = list(ingest.stream_paths(paths, chunk_bytes=chunk))
        assert got == list(jingest.stream_paths(paths, chunk_bytes=chunk))
        assert b"".join(got) == b"\n\n".join(files) == api.build_corpus(files)
        for c in got:
            c.decode("utf-8")  # no chunk cuts a UTF-8 sequence
    corpus = b"\n\n".join(files)
    data, starts = PreTokenizer().pre_tokenize_bytes(corpus)
    _assert_equal(ingest.make_stream_chunked(ingest.stream_paths(paths, chunk_bytes=64)),
                  ingest.make_stream(data, starts, dedup=True))


def test_stream_paths_never_cut_a_character_of_nfd_text(tmp_path):
    """Files of decomposed text (NFD accents and conjoining jamo) larger
    than a chunk: every chunk decodes, so each is normalized, and the
    streamed stream equals the monolithic one. The JAX package's
    stream_paths yields a buffer of exactly chunk_bytes as it is, so a cut
    inside a character sends that chunk down the raw-bytes path, without
    NFC, and its stream differs."""
    import unicodedata

    text = unicodedata.normalize("NFD", "café naïve étude 한국어 조합 각 " * 120)
    path = tmp_path / "nfd.txt"
    path.write_bytes(text.encode())
    data, starts = PreTokenizer().pre_tokenize_bytes(text.encode())
    whole = ingest.make_stream(data, starts, dedup=True)
    for chunk in (100, 256, 1000):
        chunks = list(ingest.stream_paths([str(path)], chunk_bytes=chunk))
        assert b"".join(chunks) == text.encode()
        assert all(len(c) <= chunk and c.decode("utf-8") for c in chunks[:-1])
        _assert_equal(ingest.make_stream_chunked(iter(chunks)), whole)
    jax_chunks = list(jingest.stream_paths([str(path)], chunk_bytes=256))
    assert not all(_decodes(c) for c in jax_chunks)
    assert jingest.make_stream_chunked(iter(jax_chunks)).n != whole.n


def _decodes(data: bytes) -> bool:
    try:
        data.decode("utf-8")
        return True
    except UnicodeDecodeError:
        return False


def test_utf8_safe_split():
    buf = "aé中".encode()  # 1 + 2 + 3 bytes
    assert [ingest._utf8_safe_split(buf, k) for k in range(8)] == [
        jingest._utf8_safe_split(buf, k) for k in range(8)] == [0, 1, 1, 3, 3, 3, 6, 6]


@pytest.fixture(scope="module")
def corpus_files(tmp_path_factory, english_text):
    d = tmp_path_factory.mktemp("corpus")
    (d / "a.txt").write_text(english_text[:3000])
    (d / "b.md").write_text(english_text[3000:5000] + " café naïve")
    return [str(d)]


@pytest.fixture(scope="module")
def jax_files_result(corpus_files):
    _, res = japi.train_files(corpus_files, japi.TrainConfig(vocab_size=300, show_progress=False), chunk_bytes=777)
    return res


@pytest.mark.parametrize("kw", [dict(device="cpu"), dict(device="cpu", backend="dist"), dict(backend="cpu")],
                         ids=["cuda-on-cpu", "dist-on-cpu", "reference"])
def test_train_files_equals_jax(corpus_files, jax_files_result, kw):
    tok, res = api.train_files(corpus_files, api.TrainConfig(vocab_size=300, show_progress=False, **kw),
                               chunk_bytes=777)
    assert res.merges == jax_files_result.merges and res.merge_counts == jax_files_result.merge_counts
    assert tok.model.vocab == [bytes(v) for v in jax_files_result.vocab]
    # the stream, hence the merge list, is the one api.train makes of the files
    files = [open(p, "rb").read() for p in api.collect_files(corpus_files)]
    _, whole = api.train(files, api.TrainConfig(vocab_size=300, show_progress=False, device="cpu"))
    assert whole.merges == res.merges


def test_train_files_byte_level_goes_through_train(corpus_files):
    cfg = dict(vocab_size=280, pre_tokenize=False, show_progress=False)
    _, res = api.train_files(corpus_files, api.TrainConfig(device="cpu", **cfg))
    _, ref = japi.train_files(corpus_files, japi.TrainConfig(**cfg))
    assert res.merges == ref.merges
