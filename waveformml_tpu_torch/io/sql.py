"""SQLite calibration access (the port's copy of
waveformml_tpu/io/sql.py): per-segment gains, energy resolutions and times
and the per-PMT calibration curves (``CalCurve``, a scipy smoothing spline
through a curve's graph points) from the experiment's calibration schema
(named_object, segment_response, calibration_group, pmt_response,
graph_points), the waveform-parameter sweep database (``WFParamsDB``), and
a synthetic calibration database in that schema for tests. scipy is
imported when a curve is first evaluated."""
from __future__ import annotations

import sqlite3
from math import floor
from typing import Dict, List, Optional, Sequence, Tuple

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


class CalCurve:
    """A calibration curve's graph points and its scipy smoothing spline
    (weighted by 1/dy unless some dy is 0); a curve without points is
    falsy."""

    def __init__(self):
        self.xs: List[float] = []
        self.ys: List[float] = []
        self.xerr: List[float] = []
        self.yerr: List[float] = []
        self.spline = None

    def __len__(self) -> int:
        return len(self.xs)

    def add_point(self, x: float, y: float, dx: float = 0.0, dy: float = 0.0) -> None:
        self.xs.append(x)
        self.ys.append(y)
        self.xerr.append(dx)
        self.yerr.append(dy)

    def sort(self) -> None:
        order = sorted(zip(self.xs, self.ys, self.xerr, self.yerr))
        self.xs, self.ys, self.xerr, self.yerr = (list(t) for t in zip(*order))

    def get_spline(self) -> None:
        from scipy.interpolate import splrep

        if 0 in self.yerr:
            self.spline = splrep(self.xs, self.ys)
        else:
            self.spline = splrep(self.xs, self.ys, w=[1.0 / y for y in self.yerr])

    def eval(self, x):
        from scipy.interpolate import splev

        if self.spline is None:
            self.get_spline()
        return splev(x, self.spline)

    def __repr__(self):
        return f"CalCurve(x={self.xs}, y={self.ys})"


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

    def get_curves(self):
        """The group's per-channel curves, one dict ``{chan: CalCurve or
        None}`` each of attenuation, light sum, time, linearity, PSD and
        time interpolation, and ``e_ncapt`` ``[NX, NY, 2]``."""
        curves: Tuple[Dict[int, Optional[CalCurve]], ...] = tuple({} for _ in range(6))
        e_ncapt = np.zeros((NX, NY, 2), dtype=np.float32)
        row = self.fetchone("SELECT pmt_response_id FROM calibration_group WHERE object_id = ?",
                            (self.calgroup_id,))
        pmt_response_id = row[0] if row else None
        if pmt_response_id:
            for r in self.fetchall(
                    "SELECT chan, atten_curve_id, lsum_curve_id, time_curve_id, "
                    "linearity_curve_id, psd_curve_id, t_interp_curve_id, E_ncapt "
                    "FROM pmt_response WHERE object_id = ?", (pmt_response_id,)):
                if r[0] is None:
                    continue
                chan = int(r[0])
                for k in range(6):
                    curves[k][chan] = self.get_cal_curve(r[k + 1])
                x, y, side = chan_to_coords(chan)
                e_ncapt[x, y, side] = r[7]
        return (*curves, e_ncapt)

    def get_cal_curve(self, obj_id) -> Optional[CalCurve]:
        """The curve of a graph-points object, None without an id."""
        if not obj_id:
            return None
        curve = CalCurve()
        for r in self.fetchall("SELECT x, y, dx, dy FROM graph_points WHERE object_id = ?",
                               (obj_id,)):
            curve.add_point(*r)
        return curve


class WFParamsDB(SQLiteBase):
    """The waveform-simulation parameter sweep: parameter sets
    (``param_set``) and each set's per-segment curve differences from a
    calibration (``curve_diffs``)."""

    def insert_set(self, param_set: Dict) -> None:
        self.insert_dict("param_set", param_set)

    def get_unique_name(self) -> str:
        self.execute("SELECT seq FROM SQLITE_SEQUENCE WHERE name = 'param_set'")
        result = self.cur.fetchone()
        return f"WaveCal{int(result[0]) + 1}" if result else "WaveCal1"

    def retrieve_simnames_for_eval(self, calname: str):
        self.execute(
            "SELECT id, name FROM param_set WHERE id NOT IN "
            "(SELECT p.id FROM param_set p LEFT JOIN curve_diffs c "
            "ON c.param_set_id = p.id WHERE c.calname = ?)", (calname,))
        return self.cur.fetchall()

    def insert_eval_for_seg(self, calname: str, seg: int, wfid: int,
                            params: Sequence[float]) -> None:
        self.insert_dict("curve_diffs", {
            "param_set_id": wfid, "calname": calname, "seg": seg,
            "normed_diff": sum(params), "psd_nd0": params[0], "psd_nd1": params[1],
            "att_nd0": params[2], "att_nd1": params[3],
            "t_nd0": params[4], "t_nd1": params[5]})

    def query_smallest_diffs(self, calname: str, seg: int, params=None,
                             limit: int = 10, min=None, max=None):
        plist = (", p." + ", p.".join(params)) if params else ""
        where = ""
        if min is not None:
            where += f" and CAST(LTRIM(p.name, 'WaveCal') AS INTEGER) >= {int(min)}"
        if max is not None:
            where += f" and CAST(LTRIM(p.name, 'WaveCal') AS INTEGER) <= {int(max)}"
        self.execute(
            f"SELECT c.seg, p.name, c.normed_diff, c.att_nd0, c.att_nd1, c.t_nd0, "
            f"c.t_nd1, c.psd_nd0, c.psd_nd1{plist} FROM param_set p LEFT JOIN "
            f"curve_diffs c ON c.param_set_id = p.id WHERE c.seg = ? AND "
            f"c.calname = ?{where} ORDER BY c.normed_diff ASC LIMIT {int(limit)}",
            (seg, calname))
        return self.cur.fetchall()


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
