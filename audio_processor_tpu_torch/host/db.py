"""Database persistence: call / chunk / message / call_metadata.

Same schema, upsert semantics, and public API as the reference's
DatabaseManager (services/database_manager.py:24-506): four tables with
``ON CONFLICT ... DO UPDATE`` idempotent writes, per-statement
commit/rollback, and the hardcoded B2C/B2B destination-number mapping.

Backends: PostgreSQL (psycopg2, when installed) and SQLite (stdlib) —
``database_type: sqlite`` needs no external service, which the
reference could not do.
"""

from __future__ import annotations

import logging
import threading
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

B2C_NUMBERS = {"220", "0529000220", "+212529000220",
               "0529000135", "+212529000135"}
B2B_NUMBERS = {"0529292929", "0529101010",
               "0529000136", "+212529000136"}

_TABLES = [
    """CREATE TABLE IF NOT EXISTS call (
        id_enregistrement VARCHAR(255) PRIMARY KEY,
        emotion_client_globale VARCHAR,
        ton_agent_global VARCHAR,
        topics VARCHAR,
        duration_seconds FLOAT
    )""",
    """CREATE TABLE IF NOT EXISTS chunk (
        id_chunk VARCHAR,
        id_enregistrement VARCHAR(255),
        transcription_chunk TEXT,
        transcription_agent TEXT,
        transcription_client TEXT,
        emotion_client VARCHAR,
        ton_agent VARCHAR,
        PRIMARY KEY (id_chunk, id_enregistrement),
        FOREIGN KEY (id_enregistrement)
            REFERENCES call(id_enregistrement) ON DELETE CASCADE
    )""",
    """CREATE TABLE IF NOT EXISTS message (
        order_message INTEGER NOT NULL,
        id_enregistrement VARCHAR(255),
        text TEXT,
        speaker VARCHAR,
        PRIMARY KEY (order_message, id_enregistrement),
        FOREIGN KEY (id_enregistrement)
            REFERENCES call(id_enregistrement) ON DELETE CASCADE,
        CHECK (order_message >= 1)
    )""",
    """CREATE TABLE IF NOT EXISTS call_metadata (
        id_enregistrement VARCHAR(255) PRIMARY KEY,
        agent_id VARCHAR,
        call_id VARCHAR,
        destination_number VARCHAR,
        source_number VARCHAR,
        agent_name VARCHAR,
        call_date {timestamp_type},
        queue_name VARCHAR,
        business_type VARCHAR,
        FOREIGN KEY (id_enregistrement)
            REFERENCES call(id_enregistrement) ON DELETE CASCADE
    )""",
]

_INDEXES = [
    "CREATE INDEX IF NOT EXISTS idx_call_id_enregistrement "
    "ON call(id_enregistrement)",
    "CREATE INDEX IF NOT EXISTS idx_chunk_id_enregistrement "
    "ON chunk(id_enregistrement)",
    "CREATE INDEX IF NOT EXISTS idx_message_id_enregistrement "
    "ON message(id_enregistrement)",
    "CREATE INDEX IF NOT EXISTS idx_call_metadata_agent_id "
    "ON call_metadata(agent_id)",
    "CREATE INDEX IF NOT EXISTS idx_call_metadata_call_id "
    "ON call_metadata(call_id)",
    "CREATE INDEX IF NOT EXISTS idx_call_metadata_call_date "
    "ON call_metadata(call_date)",
]


class DatabaseManager:
    def __init__(self, config):
        self.config = config
        self.db_type = str(config.get("database_type",
                                      "postgresql")).lower()
        self.connection = None
        self._lock = threading.Lock()
        self.setup_database()

    # ------------------------------------------------------------------
    def setup_database(self):
        self._connect()
        self.create_tables()
        logger.info("%s database initialized", self.db_type)

    def _connect(self):
        if self.db_type == "postgresql":
            try:
                import psycopg2  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "PostgreSQL support requires psycopg2; set "
                    "database_type: sqlite for a dependency-free backend"
                ) from e
            import psycopg2

            self.connection = psycopg2.connect(
                host=self.config.get("db_host", "localhost"),
                port=self.config.get("db_port", 55432),
                database=self.config.get("db_name", "audio_processing"),
                user=self.config.get("db_user", "postgres"),
                password=self.config.get("db_password", ""),
            )
            self.connection.autocommit = False
            self._ph = "%s"
            self._ts_type = "TIMESTAMPTZ"
        elif self.db_type in ("sqlite", "memory"):
            import sqlite3

            if self.db_type == "memory":
                path = ":memory:"
            else:
                path = self.config.get("db_path") or str(
                    Path(self.config.get("output_folder", "."))
                    / "audio_processing.db")
                Path(path).parent.mkdir(parents=True, exist_ok=True)
            # timeout=30: multi-host runs (parallel/distributed) may
            # share one DB file across processes; WAL serializes the
            # writers and the busy handler waits instead of raising
            # "database is locked" at the first contention.
            self.connection = sqlite3.connect(
                path, check_same_thread=False, timeout=30.0)
            if self.db_type == "sqlite":
                # WAL + NORMAL sync: per-statement commits (reference
                # semantics, one commit per row) stop paying a full
                # fsync each — WAL appends are durable to application
                # crash and safe to OS crash short of power loss,
                # which is the right trade for re-runnable batch
                # ingest guarded by idempotence markers.
                try:
                    self.connection.execute("PRAGMA journal_mode=WAL")
                    self.connection.execute("PRAGMA synchronous=NORMAL")
                except Exception:  # pragma: no cover - ancient sqlite
                    pass
            self._ph = "?"
            self._ts_type = "TIMESTAMP"
        else:
            raise ValueError(f"unknown database_type {self.db_type!r}")

    def _is_connection_error(self, e: Exception) -> bool:
        """Lost/closed-connection errors worth one reconnect attempt.
        (The reference has no reconnect — a dropped PostgreSQL
        connection fails every subsequent row; beyond-reference.)"""
        if self.db_type == "postgresql":
            try:
                import psycopg2

                return isinstance(e, (psycopg2.OperationalError,
                                      psycopg2.InterfaceError))
            except ImportError:  # pragma: no cover
                return False
        import sqlite3

        return isinstance(e, sqlite3.ProgrammingError) and \
            "closed" in str(e).lower()

    def _execute(self, sql: str, params: tuple = (), fetch: str = ""):
        """Per-statement commit/rollback (reference semantics), with
        one reconnect-and-retry on a lost connection. ``:memory:``
        databases are excluded (a reconnect would silently start from
        an empty schema — fail loudly instead)."""
        sql = sql.replace("%s", self._ph)
        with self._lock:
            try:
                return self._execute_locked(sql, params, fetch)
            except Exception as e:
                if self.db_type == "memory" \
                        or not self._is_connection_error(e):
                    raise
                logger.warning(
                    "database connection lost (%s); reconnecting", e)
                try:
                    self.connection.close()
                except Exception:
                    pass
                self._connect()
                return self._execute_locked(sql, params, fetch)

    def _execute_locked(self, sql: str, params: tuple, fetch: str):
        cur = self.connection.cursor()
        try:
            cur.execute(sql, params)
            rows = None
            if fetch == "one":
                row = cur.fetchone()
                cols = [d[0] for d in cur.description] if row else []
                rows = dict(zip(cols, row)) if row else None
            elif fetch == "all":
                cols = [d[0] for d in cur.description]
                rows = [dict(zip(cols, r)) for r in cur.fetchall()]
            self.connection.commit()
            return rows
        except Exception:
            try:
                self.connection.rollback()
            except Exception:  # connection itself is gone
                pass
            raise
        finally:
            try:
                cur.close()
            except Exception:  # pragma: no cover
                pass

    def create_tables(self):
        for ddl in _TABLES:
            self._execute(ddl.format(timestamp_type=self._ts_type))
        for idx in _INDEXES:
            self._execute(idx)

    # ------------------------------------------------------------------
    def insert_call(self, call_data: Dict[str, Any]) -> str:
        if "id_enregistrement" not in call_data:
            raise ValueError("id_enregistrement is required for call records")
        self._execute(
            """INSERT INTO call (id_enregistrement, emotion_client_globale,
                ton_agent_global, topics, duration_seconds)
               VALUES (%s, %s, %s, %s, %s)
               ON CONFLICT (id_enregistrement) DO UPDATE SET
                 emotion_client_globale = EXCLUDED.emotion_client_globale,
                 ton_agent_global = EXCLUDED.ton_agent_global,
                 topics = EXCLUDED.topics,
                 duration_seconds = EXCLUDED.duration_seconds""",
            (call_data["id_enregistrement"],
             call_data.get("emotion_client_globale", ""),
             call_data.get("ton_agent_global", ""),
             call_data.get("topics", ""),
             call_data.get("duration_seconds", 0)))
        return call_data["id_enregistrement"]

    def insert_chunk(self, chunk_data: Dict[str, Any]) -> str:
        if "id_chunk" not in chunk_data:
            import uuid

            chunk_data["id_chunk"] = str(uuid.uuid4())
        if "id_enregistrement" not in chunk_data:
            raise ValueError("id_enregistrement is required for chunk records")
        self._execute(
            """INSERT INTO chunk (id_chunk, id_enregistrement,
                transcription_chunk, transcription_agent,
                transcription_client, emotion_client, ton_agent)
               VALUES (%s, %s, %s, %s, %s, %s, %s)
               ON CONFLICT (id_chunk, id_enregistrement) DO UPDATE SET
                 transcription_chunk = EXCLUDED.transcription_chunk,
                 transcription_agent = EXCLUDED.transcription_agent,
                 transcription_client = EXCLUDED.transcription_client,
                 emotion_client = EXCLUDED.emotion_client,
                 ton_agent = EXCLUDED.ton_agent""",
            (chunk_data["id_chunk"], chunk_data["id_enregistrement"],
             chunk_data.get("transcription_chunk", ""),
             chunk_data.get("transcription_agent", ""),
             chunk_data.get("transcription_client", ""),
             chunk_data.get("emotion_client", ""),
             chunk_data.get("ton_agent", "")))
        return chunk_data["id_chunk"]

    def insert_message(self, message_data: Dict[str, Any]):
        for req in ("order_message", "id_enregistrement"):
            if req not in message_data:
                raise ValueError(f"{req} is required for message records")
        self._execute(
            """INSERT INTO message (order_message, id_enregistrement,
                text, speaker) VALUES (%s, %s, %s, %s)""",
            (message_data["order_message"],
             message_data["id_enregistrement"],
             message_data.get("text", ""),
             message_data.get("speaker", "")))
        return message_data["order_message"]

    def _parse_date(self, date_str: Optional[str]) -> Optional[datetime]:
        """Metadata date format DD/MM/YYYY HH:MM:SS
        (reference: database_manager.py:279-288)."""
        if not date_str:
            return None
        try:
            return datetime.strptime(date_str, "%d/%m/%Y %H:%M:%S")
        except ValueError:
            logger.warning("Failed to parse date: %s", date_str)
            return None

    def insert_call_metadata(self, id_enregistrement: str,
                             metadata_json: Dict[str, Any]) -> str:
        if not self.get_call_by_id_enregistrement(id_enregistrement):
            # Skip metadata for files that don't exist on disk
            # (reference: database_manager.py:294-301).
            import os

            audio = (f'{self.config.get("input_folder")}/'
                     f'{id_enregistrement}.ogg')
            audio_wav = (f'{self.config.get("input_folder")}/'
                         f'{id_enregistrement}.wav')
            if not os.path.exists(audio) and not os.path.exists(audio_wav):
                logger.warning("Audio file missing for metadata %s; "
                               "skipping", id_enregistrement)
                return id_enregistrement
            self.insert_call({"id_enregistrement": id_enregistrement})
        date_val = self._parse_date(metadata_json.get("DATE_"))
        if self._ph == "?" and date_val is not None:
            date_val = date_val.isoformat()
        self._execute(
            """INSERT INTO call_metadata (id_enregistrement, agent_id,
                call_id, destination_number, source_number, agent_name,
                call_date, queue_name, business_type)
               VALUES (%s, %s, %s, %s, %s, %s, %s, %s, %s)
               ON CONFLICT (id_enregistrement) DO UPDATE SET
                 agent_id = EXCLUDED.agent_id,
                 call_id = EXCLUDED.call_id,
                 destination_number = EXCLUDED.destination_number,
                 source_number = EXCLUDED.source_number,
                 agent_name = EXCLUDED.agent_name,
                 call_date = EXCLUDED.call_date,
                 queue_name = EXCLUDED.queue_name,
                 business_type = EXCLUDED.business_type""",
            (id_enregistrement,
             metadata_json.get("AGENT_ID"),
             metadata_json.get("CALL_ID"),
             metadata_json.get("DESTINATION_NUMBER"),
             metadata_json.get("SOURCE_NUMBER"),
             metadata_json.get("AGENT_NAME"),
             date_val,
             metadata_json.get("QUEUE_NAME"),
             metadata_json.get("BUSINESS_TYPE")))
        return id_enregistrement

    def update_call_sentiment(self, id_enregistrement: str,
                              emotion_client: str, ton_agent: str,
                              topics: str):
        self._execute(
            """UPDATE call SET emotion_client_globale = %s,
                ton_agent_global = %s, topics = %s
               WHERE id_enregistrement = %s""",
            (emotion_client, ton_agent, topics, id_enregistrement))

    # ------------------------------------------------------------------
    def get_call_by_id_enregistrement(self, cid: str
                                      ) -> Optional[Dict[str, Any]]:
        try:
            return self._execute(
                "SELECT * FROM call WHERE id_enregistrement = %s",
                (cid,), fetch="one")
        except Exception as e:
            logger.error("Failed to get call: %s", e)
            return None

    def get_chunks_by_id_enregistrement(self, cid: str
                                        ) -> List[Dict[str, Any]]:
        try:
            return self._execute(
                "SELECT * FROM chunk WHERE id_enregistrement = %s "
                "ORDER BY id_chunk", (cid,), fetch="all") or []
        except Exception as e:
            logger.error("Failed to get chunks: %s", e)
            return []

    def get_messages_by_id_enregistrement(self, cid: str
                                          ) -> List[Dict[str, Any]]:
        try:
            return self._execute(
                "SELECT * FROM message WHERE id_enregistrement = %s "
                "ORDER BY order_message", (cid,), fetch="all") or []
        except Exception as e:
            logger.error("Failed to get messages: %s", e)
            return []

    def delete_messages_by_id_enregistrement(self, cid: str) -> None:
        """Clear a call's message rows before re-insert: the message
        path refreshes idempotently on reprocess like the upserted
        call/chunk tables (the reference plain-inserts but ships the
        message path disabled, audio_processor.py:354-358, so it never
        reprocesses into this table)."""
        self._execute("DELETE FROM message WHERE id_enregistrement = %s",
                      (cid,))

    def get_chunk_by_id_enregistrement_and_id(self, cid: str,
                                              id_chunk: str
                                              ) -> Optional[Dict[str, Any]]:
        try:
            return self._execute(
                "SELECT * FROM chunk WHERE id_enregistrement = %s "
                "AND id_chunk = %s", (cid, id_chunk), fetch="one")
        except Exception as e:
            logger.error("Failed to get chunk: %s", e)
            return None

    def get_message_by_id_enregistrement_and_order_message(
            self, cid: str, order_message: int
    ) -> Optional[Dict[str, Any]]:
        try:
            return self._execute(
                "SELECT * FROM message WHERE id_enregistrement = %s "
                "AND order_message = %s", (cid, order_message),
                fetch="one")
        except Exception as e:
            logger.error("Failed to get message: %s", e)
            return None

    def get_calls_by_agent_id(self, agent_id: str) -> List[Dict[str, Any]]:
        try:
            return self._execute(
                """SELECT c.*, m.agent_id, m.agent_name, m.queue_name,
                          m.call_date
                   FROM call c
                   JOIN call_metadata m
                     ON c.id_enregistrement = m.id_enregistrement
                   WHERE m.agent_id = %s
                   ORDER BY m.call_date DESC""",
                (agent_id,), fetch="all") or []
        except Exception as e:
            logger.error("Failed to get calls by agent_id: %s", e)
            return []

    def get_call_metadata(self, cid: str) -> Optional[Dict[str, Any]]:
        try:
            return self._execute(
                "SELECT * FROM call_metadata WHERE id_enregistrement = %s",
                (cid,), fetch="one")
        except Exception as e:
            logger.error("Failed to get call metadata: %s", e)
            return None

    def get_business_type(self, cid: str) -> Optional[str]:
        try:
            row = self._execute(
                "SELECT business_type FROM call_metadata "
                "WHERE id_enregistrement = %s", (cid,), fetch="one")
            return row["business_type"] if row else None
        except Exception as e:
            logger.error("Failed to get business type: %s", e)
            return None

    def get_processing_stats(self) -> Dict[str, Any]:
        try:
            def count(sql):
                row = self._execute(sql, fetch="one")
                return list(row.values())[0] if row else 0

            total_calls = count("SELECT COUNT(*) AS c FROM call")
            total_chunks = count("SELECT COUNT(*) AS c FROM chunk")
            processed = count("SELECT COUNT(*) AS c FROM call "
                              "WHERE emotion_client_globale IS NOT NULL")
            total_messages = count("SELECT COUNT(*) AS c FROM message")
            total_metadata = count("SELECT COUNT(*) AS c FROM call_metadata")
            return {
                "total_calls": total_calls,
                "total_chunks": total_chunks,
                "processed_calls": processed,
                "total_messages": total_messages,
                "total_metadata": total_metadata,
                "processing_rate": (processed / total_calls * 100
                                    if total_calls else 0),
            }
        except Exception as e:
            logger.error("Failed to get processing stats: %s", e)
            return {"total_calls": 0, "total_chunks": 0,
                    "processed_calls": 0, "total_messages": 0,
                    "total_metadata": 0, "processing_rate": 0}

    # ------------------------------------------------------------------
    def business_type(self, destination_number: Optional[str]) -> str:
        """B2C/B2B from hardcoded destination numbers
        (reference: database_manager.py:482-506)."""
        dest = str(destination_number).strip() \
            if destination_number is not None else ""
        if dest in B2C_NUMBERS:
            return "B2C"
        if dest in B2B_NUMBERS:
            return "B2B"
        return "UNKNOWN"

    def close(self):
        if self.connection:
            self.connection.close()
            logger.info("Database connection closed")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
