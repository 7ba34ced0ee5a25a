"""The port's usage store (faster_qwen3_tts_tpu_torch/usage_db.py).

The usage-store tests of tests/test_servers.py run against the port's copy,
then the copy is held against the JAX package's `servers/usage_db.py`: the
same secret gives the same pseudonyms, a token made by either gate verifies
in the other (and an expired or foreign-fingerprint one fails in both), one
sqlite file is counted the same by both stores, and a migrated legacy file
has the same schema. Standard library only: no aiohttp."""
import sqlite3
import time
from datetime import datetime, timezone

import pytest

from faster_qwen3_tts_tpu_torch import usage_db as port_db
from servers import usage_db as jax_db

STORES = {"port": port_db, "jax": jax_db}


def test_usage_db_quota_and_pseudonymization(tmp_path):
    db = port_db.UsageDB(tmp_path / "usage.sqlite3", hash_secret=b"s3cret", daily_free_limit=3)
    for i in range(3):
        payload = db.consume("alice@example", username="alice")
        assert payload["used_today"] == i + 1
        assert payload["remaining"] == 3 - (i + 1)
    with pytest.raises(port_db.QuotaExceeded):
        db.consume("alice@example", username="alice")
    # pro users bypass the limit
    for _ in range(5):
        payload = db.consume("bob", username="bob", is_pro=True)
    assert payload["limit"] is None and payload["remaining"] is None
    # raw identifiers never at rest: only HMAC pseudonyms in the file
    raw = (tmp_path / "usage.sqlite3").read_bytes()
    assert b"alice@example" not in raw
    assert db.hash_user("alice@example").encode() in raw
    # get_usage does not consume
    before = db.get_usage("bob", is_pro=True)["used_today"]
    assert db.get_usage("bob", is_pro=True)["used_today"] == before


def _legacy_file(path):
    with sqlite3.connect(path) as con:
        con.execute("CREATE TABLE usage_daily (user_sub TEXT, day TEXT, is_pro INTEGER,"
                    " count INTEGER, updated_at INTEGER, username TEXT)")
        con.execute("INSERT INTO usage_daily VALUES ('carol', '2026-08-16', 0, 7, 123, 'carol')")


def test_usage_db_legacy_migration(tmp_path):
    path = tmp_path / "usage.sqlite3"
    _legacy_file(path)
    db = port_db.UsageDB(path, hash_secret=b"k", daily_free_limit=10)
    # the migrated count is under the pseudonymized key
    with sqlite3.connect(path) as con:
        db._ensure_db_locked()
        rows = con.execute("SELECT user_key, count FROM usage_daily").fetchall()
    assert rows == [(db.hash_user("carol"), 7)]
    with sqlite3.connect(path) as con:
        cols = {r[1] for r in con.execute("PRAGMA table_info(usage_daily)").fetchall()}
    assert "user_sub" not in cols and "user_key" in cols


def test_web_gate_tokens():
    gate = port_db.WebGate(secret=b"gate", ttl_seconds=100)
    tok = gate.make_token("1.2.3.4|ua")
    assert gate.verify(tok, "1.2.3.4|ua")
    assert not gate.verify(tok, "5.6.7.8|ua")  # bound to the fingerprint
    assert not gate.verify("garbage", "1.2.3.4|ua")
    # expired: a token with an old timestamp
    ts = str(int(time.time()) - 1000)
    old = f"{ts}.n.{gate._sign(ts, 'n', '1.2.3.4|ua')}"
    assert not gate.verify(old, "1.2.3.4|ua")
    # another secret -> invalid
    assert not port_db.WebGate(secret=b"other", ttl_seconds=100).verify(tok, "1.2.3.4|ua")


@pytest.mark.parametrize("user", ["alice@example", "", "ünïcødé-用户", "x" * 300])
def test_hash_user_matches_jax(tmp_path, user):
    ours = port_db.UsageDB(tmp_path / "a.sqlite3", hash_secret=b"shared secret")
    theirs = jax_db.UsageDB(tmp_path / "b.sqlite3", hash_secret=b"shared secret")
    assert ours.hash_user(user) == theirs.hash_user(user)
    assert ours.hash_user(user) != port_db.UsageDB(tmp_path / "c.sqlite3", hash_secret=b"other").hash_user(user)


@pytest.mark.parametrize("maker, checker", [("port", "jax"), ("jax", "port")])
def test_web_gate_tokens_cross_verify(maker, checker):
    make = STORES[maker].WebGate(secret=b"gate", ttl_seconds=100)
    check = STORES[checker].WebGate(secret=b"gate", ttl_seconds=100)
    tok = make.make_token("1.2.3.4|ua")
    assert check.verify(tok, "1.2.3.4|ua") and make.verify(tok, "1.2.3.4|ua")
    for gate in (make, check):
        assert not gate.verify(tok, "5.6.7.8|ua")  # a foreign fingerprint
    ts = str(int(time.time()) - 1000)
    old = f"{ts}.n.{make._sign(ts, 'n', '1.2.3.4|ua')}"
    assert old == f"{ts}.n.{check._sign(ts, 'n', '1.2.3.4|ua')}"
    for gate in (make, check):
        assert not gate.verify(old, "1.2.3.4|ua")  # expired


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_one_sqlite_file_serves_both(tmp_path, writer, reader):
    path = tmp_path / "usage.sqlite3"
    w = STORES[writer].UsageDB(path, hash_secret=b"k", daily_free_limit=3)
    r = STORES[reader].UsageDB(path, hash_secret=b"k", daily_free_limit=3)
    for _ in range(2):
        w.consume("dave", username="dave")
    w.consume("erin", username="erin", is_pro=True)
    assert r.get_usage("dave", username="dave") == w.get_usage("dave", username="dave")
    assert r.get_usage("dave")["used_today"] == 2
    assert r.consume("dave", username="dave")["remaining"] == 0  # the third unit, counted by the reader
    with pytest.raises(STORES[writer].QuotaExceeded):
        w.consume("dave", username="dave")
    assert r.get_usage("erin", is_pro=True) == w.get_usage("erin", is_pro=True)
    today = datetime.now(timezone.utc).date().isoformat()
    assert w.get_usage("erin", is_pro=True) == {"day": today, "used_today": 1, "limit": None, "remaining": None,
                                                 "is_pro": True}


@pytest.mark.parametrize("layout", ["legacy", "fresh"])
def test_schema_matches_jax(tmp_path, layout):
    """The tables both stores make, from a legacy file or from nothing,
    have the same SQL and rows."""
    dumps = {}
    for name, store in STORES.items():
        path = tmp_path / f"{name}.sqlite3"
        if layout == "legacy":
            _legacy_file(path)
        store.UsageDB(path, hash_secret=b"k").get_usage("carol", username="carol")
        with sqlite3.connect(path) as con:
            schema = con.execute("SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY name").fetchall()
            rows = con.execute("SELECT user_key, day, is_pro, count FROM usage_daily ORDER BY day").fetchall()
        dumps[name] = schema, rows
    assert dumps["port"] == dumps["jax"]
    assert {r[1] for r in dumps["port"][0]} >= {"usage_daily", "usage_users"}
