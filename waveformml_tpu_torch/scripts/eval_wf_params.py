"""Score waveform-simulation parameter sets against a reference calibration
(the port's counterpart of scripts/EvalWFParams.py):

    python -m waveformml_tpu_torch.scripts.eval_wf_params wf.db ref.db refcal [--sim_caldb_pattern P]
    python -m waveformml_tpu_torch.scripts.eval_wf_params wf.db ref.db refcal -b N [--seg S]

For each set of the WFParams database that has no scores for ``refcal`` yet,
opens its simulated calibration (``P`` formatted with the set's name) and
stores, per segment, the normalised differences of its PSD, attenuation and
time curves from the reference's, both sides each (``curve_diffs``). With
``-b N`` it prints the N best sets of one segment instead.
"""
from __future__ import annotations

import argparse
import sys

from waveformml_tpu_torch.scripts.compare_sim_cal_curve import curve_normed_diff


def main(argv=None) -> int:
    from waveformml_tpu_torch.detector import NX, NY
    from waveformml_tpu_torch.io.sql import CalibrationDB, WFParamsDB

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("db", help="WFParams sqlite database")
    parser.add_argument("caldb", help="reference calibration database")
    parser.add_argument("calname", help="reference calibration group")
    parser.add_argument("--sim_caldb_pattern", default="{name}.db",
                        help="path pattern for each set's simulated cal db")
    parser.add_argument("--best", "-b", type=int, default=0,
                        help="print the N best fits per segment and exit")
    parser.add_argument("--seg", type=int, default=0, help="segment for --best reporting")
    args = parser.parse_args(argv)
    db = WFParamsDB(args.db)
    if args.best:
        rows = db.query_smallest_diffs(args.calname, args.seg, limit=args.best)
        print(f"best fits for calname {args.calname}, seg {args.seg}:")
        for r in rows:
            print(r)
        return 0
    ref = CalibrationDB(args.caldb, args.calname).get_curves()
    ref_atten, ref_time, ref_psd = ref[0], ref[2], ref[4]
    pending = db.retrieve_simnames_for_eval(args.calname)
    if not pending:
        print(f"Warning: no sim names pending for calname {args.calname}")
        return 0
    for wfid, name in pending:
        sim_path = args.sim_caldb_pattern.format(name=name)
        try:
            sim = CalibrationDB(sim_path, name).get_curves()
        except Exception as e:
            print(f"{name}: cannot open {sim_path} ({e}), skipping")
            continue
        sim_atten, sim_time, sim_psd = sim[0], sim[2], sim[4]
        for seg in range(NX * NY):
            params = []
            for curves_sim, curves_ref in ((sim_psd, ref_psd), (sim_atten, ref_atten),
                                           (sim_time, ref_time)):
                for side in (0, 1):
                    ch = 2 * seg + side
                    if curves_sim.get(ch) and curves_ref.get(ch):
                        params.append(curve_normed_diff(curves_sim[ch], curves_ref[ch]))
                    else:
                        params.append(float("nan"))
            db.insert_eval_for_seg(args.calname, seg, wfid, params)
        db.commit()
        print(f"{name}: evaluated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
