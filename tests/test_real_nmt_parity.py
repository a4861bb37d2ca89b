"""Real-corpus NMT staging hook + spa-eng pipeline unit tests.

The reference's NMT demo trains on the real spa-eng corpus
(/root/reference/neural_machine_translation_with_attention.py:19-86);
hermetic hosts have no egress, so the full-budget parity test AUTO-SKIPS
unless a staged copy is pointed at via `PSGD_TF_TPU_SPA_ENG` (the NMT
analog of D3's `PSGD_TF_TPU_MNIST_DIR`). Staging recipe (any machine with
egress):

    curl -LO http://storage.googleapis.com/download.tensorflow.org/data/spa-eng.zip
    unzip spa-eng.zip   # -> spa-eng/spa.txt
    PSGD_TF_TPU_SPA_ENG=$PWD/spa-eng/spa.txt \
        python -m pytest tests/test_real_nmt_parity.py -v

Everything the staged run would exercise EXCEPT the corpus bytes is
covered unconditionally below via an in-repo fixture in the reference's
exact tab-separated format: preprocessing (ref :25-43), Keras-replica
tokenization (ref :54-60), padding/split (ref :63-80), and the
`nmt_attention.run(data_path=...)` end-to-end path at toy dimensions.
"""
import os

import numpy as np
import pytest

from psgd_tf_tpu.data import spa_eng

# the reference corpus format: english<TAB>spanish (some Tatoeba dumps add
# an attribution third column, which the loader must ignore)
FIXTURE_LINES = [
    "Go.\tVe.",
    "Run!\t¡Corre!",
    "Who?\t¿Quién?",
    "Fire!\t¡Fuego!",
    "Help!\t¡Ayuda!\tCC-BY (attribution column)",
    "I ran.\tCorrí.",
    "He ran.\tÉl corrió.",
    "Go home.\tVete a casa.",
    "She ran home.\tElla corrió a casa.",
    "We ran home.\tCorrimos a casa.",
    "I see him.\tLo veo.",
    "I see her.\tLa veo.",
    "You see me.\tMe ves.",
    "They see us.\tNos ven.",
    "Go see him.\tVe a verlo.",
    "Run home now.\tCorre a casa ahora.",
]


@pytest.fixture()
def corpus(tmp_path):
    p = tmp_path / "spa.txt"
    p.write_text("\n".join(FIXTURE_LINES), encoding="utf-8")
    return str(p)


def test_preprocess_matches_reference_rules():
    # ref :25-43: NFD accent strip, lowercase, punctuation spacing, only
    # a-zA-Z?.!,¿ survive, <start>/<end> wrap
    assert (
        spa_eng.preprocess_sentence("¿Quién corrió?")
        == "<start> ¿ quien corrio ? <end>"
    )
    assert spa_eng.preprocess_sentence("He is a boy.") == "<start> he is a boy . <end>"
    # digits and stray symbols become spaces, runs collapse
    assert spa_eng.preprocess_sentence("Tom's 2nd car!") == "<start> tom s nd car ! <end>"
    # accents: NFD decomposition drops combining marks only
    assert spa_eng.preprocess_sentence("Él") == "<start> el <end>"


def test_tokenizer_is_keras_replica():
    texts = ["<start> a b a <end>", "<start> b a c <end>"]
    tok = spa_eng.fit_tokenizer(texts)
    # frequency order: a(3) then <start>/<end>/b tie at 2 broken by first
    # appearance, then c; id 0 reserved for PAD
    assert tok.word_index["a"] == 1
    assert tok.word_index["<start>"] == 2
    assert tok.word_index["b"] == 3
    assert tok.word_index["<end>"] == 4
    assert tok.word_index["c"] == 5
    assert tok.vocab_size == 6  # +1 for token 0 (ref :84-85)
    assert tok.encode(["a c unseen"]) == [[1, 5]]
    assert tok.decode([2, 1, 4]) == "<start> a <end>"


def test_load_shapes_split_and_padding(corpus):
    ds = spa_eng.load(corpus, num_examples=None, seed=0, val_fraction=0.25)
    n = len(FIXTURE_LINES)
    n_val = round(0.25 * n)
    assert ds.src_train.shape[0] == n - n_val
    assert ds.src_val.shape[0] == n_val
    # post-padding: zeros only at the tail
    for row in np.concatenate([ds.src_train, ds.src_val]):
        nz = np.nonzero(row)[0]
        assert row[: nz[-1] + 1].all(), "PAD must be a suffix (post padding)"
    # every sentence carries <start> first and <end> last
    s, e = ds.src_tok.word_index["<start>"], ds.src_tok.word_index["<end>"]
    for row in ds.src_train:
        toks = row[row != 0]
        assert toks[0] == s and toks[-1] == e
    # attribution third column never leaks into the english side
    assert "cc" not in ds.tgt_tok.word_index
    assert "attribution" not in ds.tgt_tok.word_index


def test_load_from_directory_and_zip(tmp_path, corpus):
    import shutil
    import zipfile

    d = tmp_path / "dir" / "spa-eng"
    d.mkdir(parents=True)
    shutil.copy(corpus, d / "spa.txt")
    zp = tmp_path / "spa-eng.zip"
    with zipfile.ZipFile(zp, "w") as zf:
        zf.write(corpus, "spa-eng/spa.txt")
    ref = spa_eng.load(corpus, num_examples=None)
    for alt in (str(tmp_path / "dir"), str(zp)):
        got = spa_eng.load(alt, num_examples=None)
        np.testing.assert_array_equal(got.src_train, ref.src_train)
        np.testing.assert_array_equal(got.tgt_train, ref.tgt_train)


def test_workload_real_data_path_end_to_end(corpus):
    # the exact code path a staged corpus would drive, at toy dimensions:
    # corpus -> tokenizers -> Config(vocab from data) -> mixed-format kron
    # PSGD -> epoch loop -> batched val metrics
    from psgd_tf_tpu.workloads import nmt_attention

    r = nmt_attention.run(
        data_path=corpus, batch_size=4, epochs=2, num_examples=None,
        embed=8, units=16, lr=0.05,
    )
    assert r["steps"] == 2 * (12 // 4)
    assert np.isfinite(r["loss"]) and np.isfinite(r["val_loss"])
    assert 0.0 <= r["token_accuracy"] <= 1.0
    assert r["vocab_src"] == spa_eng.fit_tokenizer(
        [spa_eng.preprocess_sentence(l.split("\t")[1]) for l in FIXTURE_LINES]
    ).vocab_size


@pytest.mark.skipif(
    spa_eng.staged_path() is None,
    reason="spa-eng corpus not staged (set PSGD_TF_TPU_SPA_ENG; see module "
    "docstring for the staging recipe)",
)
def test_nmt_real_corpus_full_budget():
    """The reference's full run (ref :236-241): 30k examples, batch 64,
    lr 0.02, FD-Hvp, 10 epochs. The reference
    publishes no NMT quality number — the bar here is the discriminating
    one documented in workloads.nmt_attention._run_real: val teacher-forced
    token accuracy > 0.5 (untrained ~unigram ceiling ~0.35)."""
    from psgd_tf_tpu.workloads import nmt_attention

    r = nmt_attention.run(data_path=spa_eng.staged_path())
    assert np.isfinite(r["val_loss"])
    assert r["success"], (
        f"spa-eng parity: val token accuracy {r['token_accuracy']:.3f} "
        "missed the 0.5 bar"
    )
