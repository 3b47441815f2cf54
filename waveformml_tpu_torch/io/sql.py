"""SQLite calibration access (the port's copy of the part of
waveformml_tpu/io/sql.py that the prediction writers use): per-segment
gains, energy resolutions and times from the experiment's calibration
schema (named_object, segment_response, calibration_group, pmt_response,
graph_points), and a synthetic database in that schema for tests. The
calibration curves (``CalCurve``) and the waveform-parameter database come
with the evaluation."""
from __future__ import annotations

import sqlite3
from math import floor
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from waveformml_tpu_torch.detector import NX, NY


class SQLiteBase:
    """A connection and cursor with a few conveniences; as a context
    manager it commits on a clean exit and rolls back on any exception."""

    def __init__(self, path: str):
        self.path = path
        self._conn = sqlite3.connect(path)
        self.cur = self._conn.cursor()

    def execute(self, sql: str, params: Sequence = ()):
        return self.cur.execute(sql, params)

    def fetchone(self, sql: str, params: Sequence = ()):
        self.execute(sql, params)
        return self.cur.fetchone()

    def fetchall(self, sql: str, params: Sequence = ()):
        self.execute(sql, params)
        return self.cur.fetchall()

    def create_table(self, name: str, collist: Sequence[str]) -> None:
        self.cur.execute(f"CREATE TABLE IF NOT EXISTS {name}({', '.join(collist)})")

    def insert_dict(self, table: str, d: Dict) -> None:
        columns = ", ".join(d.keys())
        placeholders = ", ".join("?" * len(d))
        values = [int(x) if isinstance(x, bool) else x for x in d.values()]
        self.cur.execute(f"INSERT INTO {table} ({columns}) VALUES ({placeholders})", values)

    def commit(self) -> None:
        self._conn.commit()

    def close(self) -> None:
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.cur.close()
        if exc_type is not None:
            self._conn.rollback()
        else:
            self._conn.commit()
        self._conn.close()


def chan_to_coords(chan: int) -> Tuple[int, int, int]:
    """PMT channel → (x, y, side)."""
    r = chan % 2
    seg = (chan - r) // 2
    return seg % NX, seg // NX, r


class CalibrationDB(SQLiteBase):
    """A calibration group of the experiment's calibration database; an
    unknown group raises ``KeyError``."""

    def __init__(self, path: str, calgroup: str):
        super().__init__(path)
        self.calgroup = calgroup
        self.calgroup_id: Optional[int] = None
        row = self.fetchone("SELECT object_id FROM named_object WHERE name = ?", (calgroup,))
        if not row:
            raise KeyError(f"calibration group {calgroup!r} not found in {path}")
        self.calgroup_id = row[0]

    def get_gains(self) -> np.ndarray:
        return self.get_seg_cal_values()[0]

    def get_seg_cal_values(self):
        """(gains [NX, NY, 2], eres [NX, NY, 2], rel_times [NX, NY],
        seg_times [NX, NY]), float32; gains are the absolute values."""
        gains = np.zeros((NX, NY, 2), dtype=np.float32)
        eres = np.zeros((NX, NY, 2), dtype=np.float32)
        rel_times = np.zeros((NX, NY), dtype=np.float32)
        seg_times = np.zeros((NX, NY), dtype=np.float32)
        for r in self.fetchall(
                "SELECT seg, lgain_0, lgain_1, eres_0, eres_1, rel_time, seg_time "
                "FROM segment_response WHERE calgroup_id = ?", (self.calgroup_id,)):
            seg = int(r[0])
            x, y = seg % NX, seg // NX
            gains[x, y, 0] = abs(r[1])
            gains[x, y, 1] = abs(r[2])
            eres[x, y, 0] = r[3]
            eres[x, y, 1] = r[4]
            rel_times[x, y] = r[5]
            seg_times[x, y] = r[6]
        return gains, eres, rel_times, seg_times


def get_gains(db_path: str, calgroup: str) -> np.ndarray:
    """The absolute gain of each PMT of a calibration group, ``[NX, NY, 2]``
    float64 (zero where the database has no segment row)."""
    gains = np.zeros((NX, NY, 2))
    conn = sqlite3.connect(db_path)
    try:
        cursor = conn.execute(
            "SELECT seg, lgain_0, lgain_1 FROM segment_response WHERE calgroup_id = "
            "(SELECT object_id FROM named_object WHERE name = ?)", (calgroup,))
        for row in cursor:
            seg = int(row[0])
            gains[seg % NX, floor(seg / NX), 0] = abs(row[1])
            gains[seg % NX, floor(seg / NX), 1] = abs(row[2])
    finally:
        conn.close()
    return gains


def write_synthetic_caldb(path: str, calgroup: str = "testcal", seed: int = 0,
                          n_curve_points: int = 15) -> None:
    """A calibration database in the experiment's schema with one group of
    seeded synthetic gains (about 1, a few per cent apart) and per-PMT
    attenuation and transit-time curves; the same database, for the same
    arguments, as the JAX package's writer."""
    rng = np.random.default_rng(seed)
    conn = sqlite3.connect(path)
    c = conn.cursor()
    c.execute("CREATE TABLE IF NOT EXISTS named_object (object_id INTEGER PRIMARY KEY, name TEXT)")
    c.execute("CREATE TABLE IF NOT EXISTS calibration_group (object_id INTEGER, "
              "pmt_response_id INTEGER)")
    c.execute("CREATE TABLE IF NOT EXISTS segment_response (calgroup_id INTEGER, seg INTEGER, "
              "lgain_0 REAL, lgain_1 REAL, eres_0 REAL, eres_1 REAL, rel_time REAL, "
              "seg_time REAL)")
    c.execute("CREATE TABLE IF NOT EXISTS pmt_response (object_id INTEGER, chan INTEGER, "
              "atten_curve_id INTEGER, lsum_curve_id INTEGER, time_curve_id INTEGER, "
              "linearity_curve_id INTEGER, psd_curve_id INTEGER, t_interp_curve_id INTEGER, "
              "E_ncapt REAL)")
    c.execute("CREATE TABLE IF NOT EXISTS graph_points (object_id INTEGER, x REAL, y REAL, "
              "dx REAL, dy REAL)")
    calgroup_id, pmt_response_id = 1, 2
    c.execute("INSERT INTO named_object VALUES (?, ?)", (calgroup_id, calgroup))
    c.execute("INSERT INTO calibration_group VALUES (?, ?)", (calgroup_id, pmt_response_id))
    zs = np.linspace(-650, 650, n_curve_points)
    next_curve = 100
    for seg in range(NX * NY):
        gain = 1.0 + 0.05 * rng.standard_normal()
        c.execute("INSERT INTO segment_response VALUES (?,?,?,?,?,?,?,?)",
                  (calgroup_id, seg, gain, gain * (1 + 0.02 * rng.standard_normal()),
                   1.0, 1.0, 0.0, 4.0))
        for side in (0, 1):
            chan = 2 * seg + side
            sign = -1.0 if side == 0 else 1.0
            atten_id, time_id = next_curve, next_curve + 1
            next_curve += 2
            for z in zs:
                # the light this PMT sees from a source at z, and its
                # transit time in ns, later from farther
                c.execute("INSERT INTO graph_points VALUES (?,?,?,?,?)",
                          (atten_id, float(z), float(np.exp(sign * 0.8 * z / 600)), 0.0, 0.01))
                c.execute("INSERT INTO graph_points VALUES (?,?,?,?,?)",
                          (time_id, float(z), float(20.0 - sign * z / 200.0), 0.0, 0.01))
            c.execute("INSERT INTO pmt_response VALUES (?,?,?,?,?,?,?,?,?)",
                      (pmt_response_id, chan, atten_id, None, time_id, None, None, None, 1.0))
    conn.commit()
    conn.close()
