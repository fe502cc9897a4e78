"""The port's CLI (``python -m gpu_bpe_tpu_torch.cli``, run in-process
through ``main(argv)`` on the CPU) against the JAX package's CLI, and the
port's Hugging Face interop (``core/hf_io.py``) against the ``tokenizers``
library and the JAX package.

Tolerance 0: artifacts and printed output are compared byte for byte.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")
tokenizers = pytest.importorskip("tokenizers")

from gpu_bpe_tpu import cli as jcli  # noqa: E402
from gpu_bpe_tpu.core import hf_io as jhf  # noqa: E402
from gpu_bpe_tpu_torch import api, cli  # noqa: E402
from gpu_bpe_tpu_torch.core import BPEModel, GreedyTrieEncoder  # noqa: E402
from gpu_bpe_tpu_torch.core import hf_io  # noqa: E402
from gpu_bpe_tpu_torch.core.encoder_ref import encode_merge_order  # noqa: E402
from gpu_bpe_tpu_torch.core.trainer_ref import ReferenceTrainer, bytes_to_symbols  # noqa: E402
from gpu_bpe_tpu_torch.models import BPETokenizer  # noqa: E402

SAMPLE = (
    "the quick brown fox jumps over the lazy dog, the dog sleeps. "
    "hello hello world don't they'll we've naïve café 12345 aaaa bbbb "
    "москва 北京 🙂 mixed-CASE text with\nnewlines and   spaces"
)
PARITY_TEXTS = ["hello world", "the dog", "aaaa", "aaaaaaa", "don't stop", "naïve café 🙂", "x", "",
                "  leading spaces\nand\nnewlines  ", "北京москва"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, english_text):
    d = tmp_path_factory.mktemp("cli")
    (d / "corpus").mkdir()
    (d / "corpus" / "a.txt").write_text(english_text[:4000])
    (d / "corpus" / "b.txt").write_text(english_text[4000:6000])
    return d


def _run(main, argv, capsys) -> tuple[str, str]:
    capsys.readouterr()
    assert main([str(a) for a in argv]) == 0
    out = capsys.readouterr()
    return out.out, out.err


@pytest.fixture(scope="module")
def models(workdir):
    """model.json of the JAX CLI (its device backend on the JAX CPU) and of
    the port's CLI, without and with --stream."""
    corpus = workdir / "corpus"
    out = {}
    assert jcli.main(["train", str(corpus), "-o", str(workdir / "jax.json"), "--vocab-size", "320"]) == 0
    out["jax"] = workdir / "jax.json"
    for label, extra in (("port", []), ("port_stream", ["--stream"])):
        path = workdir / f"{label}.json"
        assert cli.main(["train", str(corpus), "-o", str(path), "--vocab-size", "320", "--device", "cpu",
                         *extra]) == 0
        out[label] = path
    return out


def test_train_models_equal(models, workdir):
    blob = models["jax"].read_bytes()
    assert models["port"].read_bytes() == blob and models["port_stream"].read_bytes() == blob
    files = [p.read_bytes() for p in sorted((workdir / "corpus").iterdir())]
    tok, _ = api.train(files, api.TrainConfig(vocab_size=320, device="cpu", show_progress=False))
    assert tok.model.to_json().encode() == blob


def test_train_stderr_lines(workdir, capsys):
    """The lines the CLI prints (not the logger's) are the JAX CLI's, but
    for the seconds and rates."""
    lines = {}
    for label, main, extra in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out = workdir / f"{label}-stderr.json"
        _, err = _run(main, ["train", workdir / "corpus", "-o", out, "--vocab-size", "270", "--batch-merges", "7",
                             *extra], capsys)
        lines[label] = [ln.replace(str(out), "OUT") for ln in err.splitlines() if not ln[:2].isdigit()]
    assert lines["port"][0] == lines["jax"][0] == "corpus: 2 file(s), 6.5 KB · vocab target: 270"
    assert lines["port"][1].split(",")[:2] == lines["jax"][1].split(",")[:2] == ["✓ 14 merges", " vocab 270"]
    assert lines["port"][2:] == lines["jax"][2:] == ["→ OUT"]


@pytest.mark.parametrize("cmd", [["export-trie", "{m}", "-o", "{o}"],
                                 ["export-bin", "{m}", "{c}", "-o", "{o}", "--backend", "cpu"],
                                 ["export-bin", "{m}", "{c}", "-o", "{o}", "--device", "cpu"],
                                 ["export-hf", "{m}", "-o", "{o}"],
                                 ["export-hf", "{m}", "-o", "{o}", "--pretok", "byte-level"]],
                         ids=["trie", "bin-cpu-backend", "bin-cuda-on-cpu", "hf", "hf-byte-level"])
def test_artifacts_equal(models, workdir, capsys, cmd):
    outs = {}
    for label, main in (("jax", jcli.main), ("port", cli.main)):
        out = workdir / f"{label}.{cmd[0]}"
        argv = [a.format(m=models["jax"], c=workdir / "corpus", o=out) for a in cmd]
        if label == "jax" and "--device" in argv:
            argv = argv[: argv.index("--device")]
        _, err = _run(main, argv, capsys)
        outs[label] = (out.read_bytes(), err.replace(str(out), "OUT"))
    assert outs["port"][0] == outs["jax"][0]
    if cmd[0] != "export-bin":  # export-bin's line carries a time
        assert outs["port"][1] == outs["jax"][1]


@pytest.mark.parametrize("cmd", [["vocab"], ["encode", "the quick brown fox don't"],
                                 ["encode", "the quick brown fox", "--greedy"], ["decode", "116", "104", "9999"]])
def test_text_commands_equal(models, capsys, cmd):
    argv = [cmd[0], models["jax"], *cmd[1:]]
    assert _run(cli.main, argv, capsys) == _run(jcli.main, argv, capsys)


def test_encode_decode_round_trip(models, capsys):
    text = "the lazy dog's naïve café"
    out, _ = _run(cli.main, ["encode", models["port"], text], capsys)
    back, _ = _run(cli.main, ["decode", models["port"], *out.split()], capsys)
    assert back == text + "\n"


def test_inspect_equal(models, workdir, capsys):
    path = workdir / "inspect.bin"
    _run(cli.main, ["export-bin", models["port"], workdir / "corpus", "-o", path, "--device", "cpu"], capsys)
    tok = api.load_model(str(models["port"]), backend="cpu")
    data = b"\n\n".join(p.read_bytes() for p in sorted((workdir / "corpus").iterdir()))
    assert path.read_bytes() == api.export_bin(tok, data)
    assert _run(cli.main, ["inspect", path], capsys) == _run(jcli.main, ["inspect", path], capsys)


def test_warmup_runs(capsys):
    _, err = _run(cli.main, ["warmup", "--min-log2", "11", "--max-log2", "12", "--tokenize", "--device", "cpu"],
                  capsys)
    assert "cap 2^11:" in err and "cap 2^12:" in err and "tokenize rows 2^15 in 2^11:" in err
    assert err.rstrip().endswith("✓ kernels built, ladder run")


def test_multihost_flags(monkeypatch):
    from gpu_bpe_tpu.parallel import multihost as jmh
    from gpu_bpe_tpu_torch.parallel import multihost

    assert (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES, multihost.ENV_PROCESS_ID) == (
        jmh.ENV_COORDINATOR, jmh.ENV_NUM_PROCESSES, jmh.ENV_PROCESS_ID)
    args = cli.build_parser().parse_args(["train", "x", "--coordinator", "h:1", "--num-processes", "2",
                                          "--process-id", "1"])
    assert multihost.multihost_requested(args) and args.num_processes == 2 and args.process_id == 1
    monkeypatch.delenv(multihost.ENV_COORDINATOR, raising=False)
    assert not multihost.multihost_requested(cli.build_parser().parse_args(["train", "x"]))
    monkeypatch.setenv(multihost.ENV_COORDINATOR, "h:1")
    assert multihost.multihost_requested(cli.build_parser().parse_args(["train", "x"]))


# ───────────── Hugging Face interop (the cases of tests/test_hf_io.py) ─────────────


@pytest.fixture(scope="module")
def trained_model() -> BPEModel:
    result = ReferenceTrainer().train(bytes_to_symbols(SAMPLE.encode("utf-8") * 4), target_vocab_size=310)
    assert len(result.merges) > 20
    return BPEModel(vocab=result.vocab, merges=result.merges)


@pytest.fixture(scope="module")
def hf_trained():
    """A tokenizer.json trained by the tokenizers library itself: special
    token at id 0 and the byte alphabet not at ids 0-255."""
    tok = tokenizers.Tokenizer(tokenizers.models.BPE())
    tok.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = tokenizers.decoders.ByteLevel()
    trainer = tokenizers.trainers.BpeTrainer(vocab_size=350, special_tokens=["<|endoftext|>"],
                                             initial_alphabet=tokenizers.pre_tokenizers.ByteLevel.alphabet(),
                                             show_progress=False)
    tok.train_from_iterator([SAMPLE] * 4, trainer)
    return tok


def test_byte_table():
    table = hf_io.bytes_to_unicode()
    assert table == jhf.bytes_to_unicode() and len(set(table.values())) == 256
    assert set(table.values()) == set(tokenizers.pre_tokenizers.ByteLevel.alphabet())


@pytest.mark.parametrize("pretok", ["none", "byte-level"])
def test_export_equals_jax(trained_model, pretok):
    text = hf_io.model_to_hf_json(trained_model, pretok=pretok)
    assert text == jhf.model_to_hf_json(trained_model, pretok=pretok)
    assert BPETokenizer(trained_model, backend="cpu").export_hf_json(pretok=pretok) == text


def test_export_exact_merge_order_parity(trained_model):
    tok = tokenizers.Tokenizer.from_str(hf_io.model_to_hf_json(trained_model))
    for text in PARITY_TEXTS + [SAMPLE]:
        assert tok.encode(text, add_special_tokens=False).ids == encode_merge_order(
            text.encode("utf-8"), trained_model.merges), text
        assert tok.decode(tok.encode(text, add_special_tokens=False).ids) == text


def test_byte_level_pretok_variant(trained_model):
    tok = tokenizers.Tokenizer.from_str(hf_io.model_to_hf_json(trained_model, pretok="byte-level"))
    for word in ("hello", "the", "dog", "aaaa"):
        assert tok.encode(word, add_special_tokens=False).ids == encode_merge_order(word.encode(),
                                                                                     trained_model.merges)


@pytest.mark.parametrize("vocab,match", [([b"ab", b"ab"], "duplicate"), ([b"xy"], "merge")])
def test_export_rejects(vocab, match):
    model = BPEModel(vocab=[bytes([b]) for b in range(256)] + vocab, merges=[(ord("a"), ord("b"), 256)])
    with pytest.raises(ValueError, match=match):
        hf_io.model_to_hf_json(model)


def test_export_import_identity_and_autodetect(trained_model, tmp_path):
    model2, extras = hf_io.model_from_hf_json(hf_io.model_to_hf_json(trained_model))
    assert model2.vocab == trained_model.vocab and model2.byte_ids is None
    assert [tuple(m) for m in model2.merges] == [tuple(m) for m in trained_model.merges]
    assert extras["missing_byte_tokens"] == [] and extras["pre_split_regex"] is False
    p = tmp_path / "tokenizer.json"
    p.write_text(hf_io.model_to_hf_json(trained_model), encoding="utf-8")
    assert BPEModel.load(str(p)).vocab == trained_model.vocab


def test_import_ecosystem(hf_trained):
    text = hf_trained.to_str()
    model, extras = hf_io.model_from_hf_json(text)
    jmodel, jextras = jhf.model_from_hf_json(text)
    assert model.vocab == jmodel.vocab and model.merges == jmodel.merges and extras == jextras
    assert BPEModel.from_json(text).vocab == model.vocab
    ours = BPETokenizer(model, backend="cpu")
    assert model.byte_ids is not None  # the shuffled alphabet is detected
    for word in ("hello", "the", "dog", "jumps", "world", "aaaa", "café"):
        assert ours.encode(word) == hf_trained.encode(word, add_special_tokens=False).ids, word
    ids = [t["id"] for t in extras["added_tokens"]]
    assert ids and model.vocab[ids[0]] == b"<|endoftext|>" and extras["pre_split_regex"] is True
    data = b"the quick brown fox hello world"
    toks = GreedyTrieEncoder(model.vocab).encode(data)
    assert b"".join(bytes(model.vocab[t]) for t in np.asarray(toks)) == data


@pytest.mark.parametrize("model,match", [
    ({"type": "Unigram", "vocab": []}, "Unigram"),
    ({"type": "BPE", "vocab": {"a": 0}, "merges": [], "continuing_subword_prefix": "##"}, "byte-level"),
    ({"type": "BPE", "vocab": {"あ": 0}, "merges": []}, "byte-level"),
], ids=["unigram", "wordpiece-prefix", "non-byte-alphabet"])
def test_import_rejects(model, match):
    with pytest.raises(ValueError, match=match):
        hf_io.model_from_hf_json(json.dumps({"model": model}))


def test_missing_bytes_reported():
    table = hf_io.bytes_to_unicode()
    model, extras = hf_io.model_from_hf_json(json.dumps({"model": {"type": "BPE", "vocab": {table[ord("a")]: 0},
                                                                   "merges": []}}))
    assert len(extras["missing_byte_tokens"]) == 255
    assert encode_merge_order(b"ab", [], byte_ids=model.byte_ids) == [0, ord("b")]


def test_export_hf_cli_loads_back(trained_model, tmp_path, capsys):
    mp = tmp_path / "model.json"
    trained_model.save(str(mp))
    for pretok in ("none", "byte-level"):
        out = tmp_path / f"tokenizer-{pretok}.json"
        _run(cli.main, ["export-hf", mp, "-o", out, "--pretok", pretok], capsys)
        back = BPEModel.from_json(out.read_text(encoding="utf-8"))
        assert back.vocab == trained_model.vocab and back.merges == trained_model.merges
    tok = tokenizers.Tokenizer.from_str((tmp_path / "tokenizer-none.json").read_text(encoding="utf-8"))
    assert tok.encode("hello world", add_special_tokens=False).ids == encode_merge_order(b"hello world",
                                                                                         trained_model.merges)
