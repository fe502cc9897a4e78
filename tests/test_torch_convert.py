"""State carried across from the JAX package: a JAX TrainState after one
train_batch, converted with state_from_numpy, continues in both packages
with the same next merges; a JAX SymbolStream trains identically."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from gpu_bpe_tpu.ops import TPUTrainer, init_state  # noqa: E402
from gpu_bpe_tpu.ops.ingest import make_stream as jax_make_stream  # noqa: E402
from gpu_bpe_tpu.ops.ingest import pad_stream as jax_pad_stream  # noqa: E402
from gpu_bpe_tpu.ops.train_step import train_batch_jit  # noqa: E402
from gpu_bpe_tpu.pretok import PreTokenizer  # noqa: E402
from gpu_bpe_tpu_torch import Trainer  # noqa: E402
from gpu_bpe_tpu_torch.convert import state_from_numpy, stream_from_numpy  # noqa: E402
from gpu_bpe_tpu_torch.ops import train_step as ts  # noqa: E402


def _jax_log(st):
    md = int(st.merges_done)
    return np.asarray(st.merge_log)[:md].astype(np.int64).tolist()


@pytest.mark.parametrize("first,then", [(40, 60), (7, 30)])
def test_continue_from_jax_state(english_text, first, then):
    data, starts = PreTokenizer().pre_tokenize(english_text[:8000])
    stream = jax_make_stream(data, starts)
    padded = jax_pad_stream(stream)
    st = init_state(jnp.asarray(padded.symbols), jnp.asarray(padded.weights), stream.n, 256)
    st = train_batch_jit(st, jnp.asarray(first, jnp.int32))
    arrays = {f: np.asarray(getattr(st, f)) for f in st._fields}
    port = state_from_numpy(arrays, device="cpu")
    assert int(port.n) == int(st.n) and int(port.next_id) == 256 + first

    st2 = train_batch_jit(st, jnp.asarray(then, jnp.int32))
    port2 = ts.train_batch(port, then)
    got = ts._pack_summary(port2)[: 3 * 1024].reshape(-1, 3)[: int(port2.merges_done)].tolist()
    assert got == _jax_log(st2)
    assert int(port2.n) == int(st2.n)
    np.testing.assert_array_equal(
        port2.symbols.numpy().astype(np.uint32), np.asarray(st2.symbols)[: port2.symbols.shape[0]]
    )


def test_state_with_holes_is_refused():
    arrays = {"n": np.int32(10), "extent": np.int32(12), "dirty": np.int32(2)}
    with pytest.raises(ValueError):
        state_from_numpy(arrays, device="cpu")


def test_stream_from_numpy_trains_identically(english_text):
    data, starts = PreTokenizer().pre_tokenize(english_text[:6000])
    js = jax_make_stream(data, starts)
    ps = stream_from_numpy(js.symbols, js.weights, js.n, js.total_bytes)
    port = Trainer(device="cpu").train_stream(ps, target_vocab_size=320)
    ref = TPUTrainer().train_stream(js, target_vocab_size=320)
    assert port.merges == ref.merges and port.merge_counts == ref.merge_counts
