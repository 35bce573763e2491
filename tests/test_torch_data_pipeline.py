"""Port parity for the offline data pipeline (CPU): tokenizers, MIND and
Adressa preprocessing and the frozen-random-trunk surrogate against the JAX
package's, on the committed schema-faithful MIND fixture
(``tests/fixtures/mind_mini/``, WordPiece on its ``vocab.txt``) and on a
synthetic Adressa event log. The bar is equality: the same (2, L) frames,
byte-identical ``UserData/`` artifacts (so either package's
``load_mind_artifacts`` reads the other's), bitwise token states.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from fedrec_tpu.data import adressa as jadressa
from fedrec_tpu.data import mind as jmind
from fedrec_tpu.data import preprocess as jpre
from fedrec_tpu.data import tokenizer as jtok
from fedrec_tpu_torch.data import adressa as tadressa
from fedrec_tpu_torch.data import load_mind_artifacts
from fedrec_tpu_torch.data import mind as tmind
from fedrec_tpu_torch.data import preprocess as tpre
from fedrec_tpu_torch.data import tokenizer as ttok

FIXTURE = Path(__file__).parent / "fixtures" / "mind_mini"
ARTIFACTS = ("bert_news_index.npy", "bert_nid2index.pkl", "train_sam_uid.pkl",
             "valid_sam_uid.pkl")
HARD_TEXTS = [
    "", "   ", "Héllo, Wörld!! naïve café", "unbelievably un-believable...", "x" * 150,
    "Team wins cup final; coach's \"new\" plan (2019)", "ÅSE SØRENSEN — «sjokk»", "a\tb\nc",
    "playing played player players playfully", "中文 标题 测试",
]


def _titles() -> list[str]:
    return list(jpre.parse_news_tsv(FIXTURE / "news.tsv").values()) + HARD_TEXTS


def _assert_same_bytes(a: Path, b: Path) -> None:
    for name in ARTIFACTS:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_basic_tokenize_matches_jax():
    for text in _titles():
        for lower in (True, False):
            assert ttok.basic_tokenize(text, lower) == jtok.basic_tokenize(text, lower)


@pytest.mark.parametrize("max_len", [4, 12, 50])
def test_wordpiece_frames_match_jax(max_len):
    want_tok = jtok.WordPieceTokenizer(FIXTURE / "vocab.txt")
    got_tok = ttok.WordPieceTokenizer(FIXTURE / "vocab.txt")
    assert got_tok.vocab == want_tok.vocab and got_tok.vocab_size == want_tok.vocab_size
    assert (got_tok.pad_id, got_tok.unk_id, got_tok.cls_id, got_tok.sep_id) == (
        want_tok.pad_id, want_tok.unk_id, want_tok.cls_id, want_tok.sep_id)
    for text in _titles():
        got, want = got_tok.encode(text, max_len), want_tok.encode(text, max_len)
        assert got[0].dtype == got[1].dtype == np.int64
        np.testing.assert_array_equal(np.stack(got), np.stack(want), err_msg=text)


@pytest.mark.parametrize("vocab_size", [30522, 1000])
def test_hashing_frames_match_jax(vocab_size):
    got_tok, want_tok = ttok.HashingTokenizer(vocab_size), jtok.HashingTokenizer(vocab_size)
    for text in _titles():
        np.testing.assert_array_equal(np.stack(got_tok.encode(text, 16)),
                                      np.stack(want_tok.encode(text, 16)), err_msg=text)


def test_get_tokenizer_picks_like_jax(tmp_path):
    assert isinstance(ttok.get_tokenizer(FIXTURE / "vocab.txt"), ttok.WordPieceTokenizer)
    assert isinstance(ttok.get_tokenizer(None, vocab_size=500), ttok.HashingTokenizer)
    assert ttok.get_tokenizer(None, vocab_size=500).vocab_size == 500
    with pytest.raises(FileNotFoundError, match="vocab file not found"):
        ttok.get_tokenizer(tmp_path / "absent.txt")


@pytest.mark.parametrize("vocab", [True, False], ids=["wordpiece", "hashing"])
def test_preprocess_mind_artifacts_are_byte_identical(tmp_path, vocab):
    """The fixture's tsvs through both packages' ``preprocess_mind``: the four
    artifacts byte for byte, and each package's loader reads the other's."""
    kw = dict(vocab_path=FIXTURE / "vocab.txt" if vocab else None, max_title_len=20)
    args = (FIXTURE / "news.tsv", FIXTURE / "behaviors.tsv", FIXTURE / "behaviors_valid.tsv")
    got = tpre.preprocess_mind(*args, out_dir=tmp_path / "port", **kw)
    want = jpre.preprocess_mind(*args, out_dir=tmp_path / "jax", **kw)
    _assert_same_bytes(tmp_path / "port", tmp_path / "jax")
    np.testing.assert_array_equal(got.news_tokens, want.news_tokens)
    assert (got.nid2index, got.train_samples, got.valid_samples) == (
        want.nid2index, want.train_samples, want.valid_samples)
    assert got.num_news == 25 and len(got.train_samples) > 0 and len(got.valid_samples) > 0
    cross = load_mind_artifacts(tmp_path / "jax")
    np.testing.assert_array_equal(cross.news_tokens, got.news_tokens)
    back = jmind.load_mind_artifacts(tmp_path / "port")
    assert back.train_samples == got.train_samples


def test_preprocess_cli_matches_jax(tmp_path, capsys):
    argv = ["--news", str(FIXTURE / "news.tsv"), "--train-behaviors",
            str(FIXTURE / "behaviors.tsv"), "--valid-behaviors",
            str(FIXTURE / "behaviors_valid.tsv"), "--vocab", str(FIXTURE / "vocab.txt"),
            "--max-title-len", "30"]
    assert tpre.main([*argv, "--out-dir", str(tmp_path / "port")]) == 0
    got_line = capsys.readouterr().out
    assert jpre.main([*argv, "--out-dir", str(tmp_path / "jax")]) == 0
    want_line = capsys.readouterr().out
    _assert_same_bytes(tmp_path / "port", tmp_path / "jax")
    assert got_line.replace(str(tmp_path / "port"), "") == want_line.replace(
        str(tmp_path / "jax"), "")


def test_parse_behaviors_keeps_one_user_index_across_splits():
    known = set(jpre.parse_news_tsv(FIXTURE / "news.tsv"))
    for his in (None, 2):
        got_map, want_map = {}, {}
        got = [tpre.parse_behaviors_tsv(FIXTURE / f, known, his, got_map)
               for f in ("behaviors.tsv", "behaviors_valid.tsv")]
        want = [jpre.parse_behaviors_tsv(FIXTURE / f, known, his, want_map)
                for f in ("behaviors.tsv", "behaviors_valid.tsv")]
        assert got == want and got_map == want_map


def _write_events(path: Path, events: list[dict]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
        # the raw logs' noise: a torn line, a timeless and a titleless event
        f.write("{not json\n")
        f.write(json.dumps({"userId": "u9", "id": "adr1", "title": "t"}) + "\n")
        f.write(json.dumps({"userId": "u9", "id": "adr1", "time": "17"}) + "\n")


def test_synthetic_adressa_events_match_jax():
    kw = dict(num_users=40, num_news=60, num_topics=5, seed=3)
    assert (tadressa.make_synthetic_adressa_events(**kw)
            == jadressa.make_synthetic_adressa_events(**kw))


@pytest.mark.parametrize("vocab", [True, False], ids=["wordpiece", "hashing"])
def test_preprocess_adressa_artifacts_are_byte_identical(tmp_path, vocab):
    """A synthetic Adressa log in two files (one event log split across
    them) through both packages: artifacts byte for byte."""
    events = tadressa.make_synthetic_adressa_events(num_users=120, num_news=90, num_topics=6,
                                                    seed=1)
    half = len(events) // 2
    paths = [tmp_path / "day1.jsonl", tmp_path / "day2.jsonl"]
    _write_events(paths[0], events[:half])
    _write_events(paths[1], events[half:])
    kw = dict(vocab_path=FIXTURE / "vocab.txt" if vocab else None, max_title_len=16,
              neg_pool_size=7, valid_frac=0.2, seed=4)
    got = tadressa.preprocess_adressa(paths, tmp_path / "port", **kw)
    jadressa.preprocess_adressa(paths, tmp_path / "jax", **kw)
    _assert_same_bytes(tmp_path / "port", tmp_path / "jax")
    assert len(got.train_samples) > len(got.valid_samples) > 0
    assert tadressa.parse_adressa_events(paths) == jadressa.parse_adressa_events(paths)


def test_adressa_cli_matches_jax(tmp_path, capsys):
    path = tmp_path / "events.jsonl"
    _write_events(path, tadressa.make_synthetic_adressa_events(num_users=30, num_news=40,
                                                               seed=2))
    argv = ["--events", str(path), "--max-title-len", "12", "--seed", "5"]
    assert tadressa.main([*argv, "--out-dir", str(tmp_path / "port")]) == 0
    assert jadressa.main([*argv, "--out-dir", str(tmp_path / "jax")]) == 0
    capsys.readouterr()
    _assert_same_bytes(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_token_states_from_tokens_is_bitwise(dtype):
    data = tpre.preprocess_mind(FIXTURE / "news.tsv", FIXTURE / "behaviors.tsv",
                                vocab_path=FIXTURE / "vocab.txt", max_title_len=20)
    for vocab in (118, 30_522):
        got = tmind.token_states_from_tokens(data.news_tokens, bert_hidden=24, vocab=vocab,
                                             seed=7, dtype=dtype)
        want = jmind.token_states_from_tokens(data.news_tokens, bert_hidden=24, vocab=vocab,
                                              seed=7, dtype=dtype)
        assert got.dtype == want.dtype and got.shape == (25, 20, 24)
        np.testing.assert_array_equal(got, want)
        assert not got[0].any()  # the <unk> row: every position masked
