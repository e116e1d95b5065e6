"""CycleJournal — the crash-safe record of ONE refit cycle.

Port of the reference's ``lifecycle/journal.py``: the same file, schema,
keys and values, so a journal written by either package resumes in the
other. A single JSON file (``cycle.json`` under the lifecycle dir) rewritten
with :func:`~spark_rapids_ml_tpu_torch.core.persistence.atomic_file_write`
after every stage completes: a process killed at ANY instant leaves
either the previous journal or the new one on disk, never a truncated
file. On restart :meth:`CycleJournal.resume_or_start` decides exactly
one of three things:

- a valid, unfinished journal for the SAME identity → resume that cycle
  (the controller replays completed stages from their journaled
  payloads and re-executes only the stage that was in flight);
- a finished journal → start a fresh cycle;
- a torn file (truncated JSON), an unknown schema, or a STALE journal
  (identity mismatch — a different model name or estimator class left
  it behind) → reject it loudly (``lifecycle.journal.rejected`` counter
  + ``lifecycle`` event with the reason) and start fresh. A rejected
  journal is renamed aside, never silently deleted.

The journal also carries the REGISTER FENCE: the registry's version
high-water for the model, written *before* the register stage runs.
Re-entry compares the live registry against the fence to tell "my
register landed before the crash" (a version above the fence exists —
adopt it) from "it never landed" (re-register) — the idempotency that
keeps kill -9 from ever minting duplicate versions.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from spark_rapids_ml_tpu_torch.core.persistence import atomic_file_write
from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

SCHEMA_VERSION = 1
FILENAME = "cycle.json"

#: Stage order of one cycle; ``mark`` rejects names outside this set.
STAGES = ("ingest", "refit", "quality_gate", "register", "warm", "flip")


class CycleJournal:
    def __init__(self, directory: str, identity: Dict[str, str], cycle: int):
        self.directory = directory
        self.path = os.path.join(directory, FILENAME)
        self._data: Dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "identity": dict(identity),
            "cycle": int(cycle),
            "stages": {},
            "fence": None,
            "finished": False,
        }

    # --- construction ---

    @classmethod
    def resume_or_start(
        cls, directory: str, identity: Dict[str, str], cycle: int
    ) -> "CycleJournal":
        """The single restart decision point (see module docstring)."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, FILENAME)
        if not os.path.exists(path):
            return cls(directory, identity, cycle)
        reason = None
        data = None
        try:
            with open(path, "rb") as f:
                data = json.loads(f.read().decode("utf-8"))
        except (ValueError, OSError):
            reason = "torn"
        if reason is None:
            if not isinstance(data, dict) or data.get("schema") != SCHEMA_VERSION:
                reason = "schema"
            elif not isinstance(data.get("stages"), dict) or "cycle" not in data:
                reason = "schema"
            elif data.get("identity") != dict(identity):
                reason = "stale"
        if reason is not None:
            bump_counter("lifecycle.journal.rejected")
            emit(
                "lifecycle", action="journal_rejected", reason=reason,
                path=path,
            )
            # Keep the evidence: a rejected journal is operator-debuggable
            # state, not garbage.
            os.replace(path, path + ".rejected")
            return cls(directory, identity, cycle)
        if data.get("finished"):
            return cls(directory, identity, cycle)
        j = cls(directory, identity, int(data["cycle"]))
        j._data = data
        bump_counter("lifecycle.journal.resumed")
        emit(
            "lifecycle", action="journal_resumed", cycle=j.cycle,
            stages=sorted(data["stages"]),
        )
        return j

    # --- accessors ---

    @property
    def cycle(self) -> int:
        return int(self._data["cycle"])

    def done(self, stage: str) -> bool:
        return stage in self._data["stages"]

    def payload(self, stage: str) -> Optional[Dict[str, Any]]:
        return self._data["stages"].get(stage)

    def fence(self) -> Optional[int]:
        return self._data["fence"]

    # --- mutation (each call commits atomically) ---

    def mark(self, stage: str, payload: Optional[Dict[str, Any]] = None) -> None:
        """Record ``stage`` as complete with its payload and commit.
        Marking a stage twice is an error — re-entry must consult
        :meth:`done` first (the idempotency lives in the controller's
        replay, not in silent overwrites)."""
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}; expected one of {STAGES}")
        if self.done(stage):
            raise RuntimeError(f"stage {stage!r} already journaled this cycle")
        self._data["stages"][stage] = dict(payload or {})
        self._commit()

    def set_fence(self, high_water: int) -> None:
        self._data["fence"] = int(high_water)
        self._commit()

    def finish(self) -> None:
        """Close the cycle. The file stays on disk (finished journals are
        the cycle's audit record); the next ``resume_or_start`` treats it
        as absent."""
        self._data["finished"] = True
        self._commit()

    def _commit(self) -> None:
        atomic_file_write(
            self.path,
            json.dumps(self._data, sort_keys=True).encode("utf-8"),
        )
