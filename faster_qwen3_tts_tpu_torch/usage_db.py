"""Usage accounting and web-gate tokens for the port's browser demo server.

The port's own copy of the JAX package's `servers/usage_db.py`, on the
standard library alone (sqlite3, hmac), so that the same secret gives the
same pseudonyms and tokens in both packages and one sqlite file serves
either demo server:

- `UsageDB`: sqlite-backed daily per-user generation counts with
  HMAC-pseudonymized user keys (no raw identifiers at rest), a
  `usage_users` roster, schema migration from the legacy layout that
  stored raw `user_sub`, and a free-tier daily quota that pro users
  bypass.
- `WebGate`: HMAC-signed `ts.nonce.sig` bearer tokens bound to a client
  fingerprint with a TTL, so only clients that loaded the demo page can
  call the generation routes in web-only deployments.

`demo_server.py` wires it up.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import secrets
import sqlite3
import threading
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional


class QuotaExceeded(Exception):
    """Raised by UsageDB.consume when a free-tier user is out of quota."""

    def __init__(self, limit: int):
        self.limit = limit
        super().__init__(
            f"Daily free limit reached ({limit} generations/day). "
            "Pro users have unlimited access."
        )


def _today_key() -> str:
    return datetime.now(timezone.utc).date().isoformat()


class UsageDB:
    """Daily per-user usage counts in sqlite, keyed by HMAC pseudonyms.

    Schema (reference demo/server.py:383-411):
      usage_daily(user_key, day, is_pro, count, updated_at) PK(user_key, day)
      usage_users(user_key PK, username, is_pro, first_seen_at, last_seen_at)
    """

    def __init__(self, path, hash_secret: bytes, daily_free_limit: int = 10):
        self.path = Path(path)
        self._secret = hash_secret
        self.daily_free_limit = int(daily_free_limit)
        self._lock = threading.Lock()
        self._initialized = False

    # -- identity -----------------------------------------------------------

    def hash_user(self, user_id: str) -> str:
        """Pseudonymize a raw identifier (HMAC-SHA256, keyed) so the DB never
        stores who used the demo (reference demo/server.py:339-341)."""
        digest = hmac.new(self._secret, user_id.encode("utf-8"), hashlib.sha256).hexdigest()
        return f"fq3tuser_{digest}"

    # -- schema -------------------------------------------------------------

    def _connect(self) -> sqlite3.Connection:
        return sqlite3.connect(self.path, timeout=30)

    def _ensure_db_locked(self) -> None:
        if self._initialized:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self._connect() as con:
            self._ensure_schema(con)
        self._initialized = True

    @staticmethod
    def _create_daily(con: sqlite3.Connection) -> None:
        con.execute(
            """
            CREATE TABLE IF NOT EXISTS usage_daily (
                user_key TEXT NOT NULL,
                day TEXT NOT NULL,
                is_pro INTEGER NOT NULL DEFAULT 0,
                count INTEGER NOT NULL DEFAULT 0,
                updated_at INTEGER NOT NULL,
                PRIMARY KEY (user_key, day)
            )
            """
        )

    @staticmethod
    def _create_users(con: sqlite3.Connection) -> None:
        con.execute(
            """
            CREATE TABLE IF NOT EXISTS usage_users (
                user_key TEXT PRIMARY KEY,
                username TEXT NOT NULL,
                is_pro INTEGER NOT NULL DEFAULT 0,
                first_seen_at INTEGER NOT NULL,
                last_seen_at INTEGER NOT NULL
            )
            """
        )

    def _ensure_schema(self, con: sqlite3.Connection) -> None:
        """Create tables; migrate a legacy `usage_daily` that stored raw
        `user_sub` into the pseudonymized layout (reference
        demo/server.py:414-478)."""
        self._create_users(con)
        columns = {r[1] for r in con.execute("PRAGMA table_info(usage_daily)").fetchall()}
        if not columns:
            self._create_daily(con)
            return
        expected = {"user_key", "day", "is_pro", "count", "updated_at"}
        if columns == expected:
            return

        legacy = "usage_daily_legacy_privacy"
        con.execute(f"DROP TABLE IF EXISTS {legacy}")
        con.execute(f"ALTER TABLE usage_daily RENAME TO {legacy}")
        self._create_daily(con)
        legacy_cols = {r[1] for r in con.execute(f"PRAGMA table_info({legacy})").fetchall()}
        if {"user_sub", "day", "is_pro", "count", "updated_at"}.issubset(legacy_cols):
            rows = con.execute(
                f"SELECT user_sub, day, is_pro, count, updated_at FROM {legacy}"
            ).fetchall()
            for user_sub, day, is_pro, count, updated_at in rows:
                con.execute(
                    """
                    INSERT INTO usage_daily (user_key, day, is_pro, count, updated_at)
                    VALUES (?, ?, ?, ?, ?)
                    ON CONFLICT(user_key, day) DO UPDATE SET
                        is_pro = excluded.is_pro,
                        count = MAX(usage_daily.count, excluded.count),
                        updated_at = MAX(usage_daily.updated_at, excluded.updated_at)
                    """,
                    (self.hash_user(str(user_sub)), day, int(is_pro), int(count), int(updated_at)),
                )
            con.execute(f"DROP TABLE {legacy}")
        elif expected.issubset(legacy_cols):
            rows = con.execute(
                f"SELECT user_key, day, is_pro, count, updated_at FROM {legacy}"
            ).fetchall()
            con.executemany(
                "INSERT OR REPLACE INTO usage_daily (user_key, day, is_pro, count, updated_at)"
                " VALUES (?, ?, ?, ?, ?)",
                rows,
            )
            con.execute(f"DROP TABLE {legacy}")
        else:
            # Unknown legacy layout: keep the renamed table so no usage data
            # is silently discarded (ADVICE r2); operators can migrate by hand.
            import logging

            logging.getLogger(__name__).warning(
                "usage_daily had unrecognized columns %s; preserved as %s",
                sorted(legacy_cols), legacy,
            )

    @staticmethod
    def _record_user(con, user_key: str, username: str, is_pro: bool, now: int) -> None:
        row = con.execute(
            "SELECT first_seen_at, last_seen_at FROM usage_users WHERE user_key = ?",
            (user_key,),
        ).fetchone()
        if row:
            con.execute(
                "UPDATE usage_users SET username=?, is_pro=?, first_seen_at=?, last_seen_at=?"
                " WHERE user_key=?",
                (username, int(is_pro), min(int(row[0]), now), max(int(row[1]), now), user_key),
            )
        else:
            con.execute(
                "INSERT INTO usage_users (user_key, username, is_pro, first_seen_at, last_seen_at)"
                " VALUES (?, ?, ?, ?, ?)",
                (user_key, username, int(is_pro), now, now),
            )

    # -- quota --------------------------------------------------------------

    def _payload(self, is_pro: bool, day: str, count: int) -> dict:
        limit = None if is_pro else self.daily_free_limit
        remaining = None if is_pro else max(0, self.daily_free_limit - count)
        return {
            "day": day,
            "used_today": count,
            "limit": limit,
            "remaining": remaining,
            "is_pro": is_pro,
        }

    def get_usage(self, user_id: str, username: str = "", is_pro: bool = False) -> dict:
        day = _today_key()
        key = self.hash_user(user_id)
        now = int(time.time())
        with self._lock:
            self._ensure_db_locked()
            with self._connect() as con:
                self._record_user(con, key, username or user_id, is_pro, now)
                row = con.execute(
                    "SELECT count FROM usage_daily WHERE user_key = ? AND day = ?",
                    (key, day),
                ).fetchone()
        return self._payload(is_pro, day, int(row[0]) if row else 0)

    def consume(self, user_id: str, username: str = "", is_pro: bool = False) -> dict:
        """Consume one generation; raises QuotaExceeded for free users at the
        limit (reference demo/server.py:553-588)."""
        day = _today_key()
        key = self.hash_user(user_id)
        now = int(time.time())
        with self._lock:
            self._ensure_db_locked()
            with self._connect() as con:
                self._record_user(con, key, username or user_id, is_pro, now)
                row = con.execute(
                    "SELECT count FROM usage_daily WHERE user_key = ? AND day = ?",
                    (key, day),
                ).fetchone()
                count = int(row[0]) if row else 0
                if not is_pro and count >= self.daily_free_limit:
                    raise QuotaExceeded(self.daily_free_limit)
                count += 1
                con.execute(
                    """
                    INSERT INTO usage_daily (user_key, day, is_pro, count, updated_at)
                    VALUES (?, ?, ?, ?, ?)
                    ON CONFLICT(user_key, day) DO UPDATE SET
                        is_pro = excluded.is_pro,
                        count = excluded.count,
                        updated_at = excluded.updated_at
                    """,
                    (key, day, int(is_pro), count, now),
                )
        return self._payload(is_pro, day, count)


class WebGate:
    """Signed web-session tokens binding requests to the page load.

    Token = `ts.nonce.sig` where sig = HMAC(secret, f"{ts}.{nonce}.{fp}")
    and fp is a client fingerprint (ip|user-agent). Mirrors reference
    demo/server.py:265-291.
    """

    def __init__(self, secret: Optional[bytes] = None, ttl_seconds: int = 7200):
        self.secret = secret or secrets.token_bytes(32)
        self.ttl = int(ttl_seconds)

    def _sign(self, ts: str, nonce: str, fingerprint: str) -> str:
        msg = f"{ts}.{nonce}.{fingerprint}".encode("utf-8")
        digest = hmac.new(self.secret, msg, hashlib.sha256).digest()
        return base64.urlsafe_b64encode(digest).decode("ascii").rstrip("=")

    def make_token(self, fingerprint: str) -> str:
        ts = str(int(time.time()))
        nonce = secrets.token_urlsafe(18)
        return f"{ts}.{nonce}.{self._sign(ts, nonce, fingerprint)}"

    def verify(self, token: str, fingerprint: str) -> bool:
        try:
            ts, nonce, sig = token.split(".", 2)
            issued = int(ts)
        except (ValueError, TypeError, AttributeError):
            return False
        now = int(time.time())
        if issued > now + 60 or now - issued > self.ttl:
            return False
        return hmac.compare_digest(sig, self._sign(ts, nonce, fingerprint))
