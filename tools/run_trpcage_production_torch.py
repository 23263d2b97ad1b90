"""Trp-cage production run on one GPU through the PyTorch/CUDA port
(``isokann_tpu_torch``); the port's counterpart of
``tools/run_trpcage_production.py``.

The reference's production configuration (``scripts/trpcage.jl``):
trp-cage (TC5B) in OBC2 implicit solvent, a 100-step lag, nx = 100 x
nk = 8, chi-stratified resampling, a data cutoff of 2000, ~1000
generations.  In one process: a pilot at the reference lag, the
implied-timescale lag sweep on it (its rows written after every rung and
reused by a relaunch), the production campaign at the recommended lag
(checkpointed every ``--checkpoint-every`` generations; a relaunch into
the same ``--out`` resumes from the checkpoint), then the analysis: the
Koopman fit and rates, the resolved rates at two lags, the
Chapman-Kolmogorov test and the reactive path of the data
(``reactive_path.pdb``), and the plots (``lag_sweep.png``,
``cktest.png``, ``training.png``, ``chi.png``; matplotlib needed, a
failed plot recorded under ``*plot_error`` in the results).

Usage: python3 tools/run_trpcage_production_torch.py [--generations N]
       [--no-lag-sweep] [--steps S] [--out DIR] [--cpu]

Artifacts go to ``out/torch/<name>_production`` unless ``--out`` says
otherwise; the minimized structure is cached at ``out/torch/<name>.pdb``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TC5B = "NLYIQWLKDGGPSSGRPPPS"
OUT = os.path.join(ROOT, "out", "torch")

# the system (--sequence/--name) and the device (--cpu) of build_sim
SEQUENCE = TC5B
PDB_NAME = "trpcage"
DEVICE = None


def build_sim(steps):
    """``MDSimulation`` of the minimized peptide in OBC2 at ``steps`` a
    lag, on ``DEVICE`` (the card unless ``--cpu``)."""
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.md.fixtures import peptide_pdb

    pdb = os.path.join(OUT, f"{PDB_NAME}.pdb")
    if not os.path.exists(pdb):
        os.makedirs(OUT, exist_ok=True)
        peptide_pdb(SEQUENCE, pdb, minimize=True, implicit="obc2",
                    maxiter=1500, device=DEVICE)
    return itt.MDSimulation(pdb=pdb, steps=steps, implicit="obc2",
                            device=DEVICE)


def reactive_path_stage(iso, out, results):
    """The reactive path through the learner's start points (sigma 0.5,
    as the reference tool) written to ``out/reactive_path.pdb``; records
    its ``reactive_path_frames`` in ``results``, or the
    ``reactive_path_error`` it raised."""
    from isokann_tpu_torch.analysis import save_reactive_path

    try:
        ids = save_reactive_path(
            iso, sigma=0.5, out=os.path.join(out, "reactive_path.pdb"))
        results["reactive_path_frames"] = (int(len(ids))
                                           if ids is not None else 0)
    except Exception as e:
        results["reactive_path_error"] = str(e)
    return results


def _close(fig):
    import matplotlib.pyplot as plt
    plt.close(fig)


def save_campaign(iso, out, done, telemetry, results):
    """The campaign's checkpoint: the learner (model, optimiser, data,
    generator and the simulation at its current lag) and the telemetry."""
    iso.save(os.path.join(out, "campaign_checkpoint.pkl"))
    with open(os.path.join(out, "campaign_telemetry.json"), "w") as f:
        json.dump(dict(done=done, telemetry=telemetry,
                       lag_escalations=(results or {}).get(
                           "lag_escalations")), f)


def load_campaign(out, device=None):
    """``(iso, meta)`` of the checkpoint in ``out``, or None without one:
    ``meta`` holds ``done``, ``telemetry`` and ``lag_escalations``."""
    import isokann_tpu_torch as itt

    ckpt = os.path.join(out, "campaign_checkpoint.pkl")
    meta_p = os.path.join(out, "campaign_telemetry.json")
    if not (os.path.exists(ckpt) and os.path.exists(meta_p)):
        return None
    with open(meta_p) as f:
        meta = json.load(f)
    return itt.load(ckpt, device=device), meta


def campaign(iso, generations, iters, resamples, cutoff, telemetry,
             label="", budget_s=None, adaptive_lag=False, check_every=25,
             lag_factor=5, max_steps=62500, headroom=0.98,
             results=None, out=None, checkpoint_every=50, start_gen=0,
             already_spent=0.0):
    """The adaptive loop: a generation is ``iso.run(iters)``,
    ``resample_strat(resamples)`` and the ``cutoff`` of the oldest
    points, with a telemetry row (``gen``, ``n``, ``loss``, ``t_gen``,
    ``t_total``, ``steps``).

    ``budget_s``: stop once the last generation's time says the next one
    would pass the budget (``already_spent`` counts a resumed run's
    earlier seconds).  ``adaptive_lag``: every ``check_every``
    generations, if the training-lag slow eigenvalue is above
    ``headroom``, escalate the lag by ``lag_factor`` (up to
    ``max_steps``) through ``escalate_lag`` with ``build_sim``, warm-
    started; escalations land in ``results``.  ``out``: every
    ``checkpoint_every`` generations ``save_campaign`` writes the
    learner and the telemetry there, and a relaunch resumes from
    ``start_gen``.  Returns (seconds, generations done)."""
    import isokann_tpu_torch as itt
    from isokann_tpu_torch.workflows import (escalate_lag,
                                             training_lag_headroom)

    t_start = time.time()
    t_gen = t_start
    done = start_gen
    for g in range(start_gen, generations):
        try:
            iso.run(iters)
        except itt.DomainError:
            print(f"gen {g}: degenerate target, resampling", flush=True)
        iso.resample_strat(resamples)
        if len(iso.data) > cutoff:
            iso.data = iso.data[len(iso.data) - cutoff:]
        now = time.time()
        cur_steps = getattr(getattr(iso.data, "sim", None), "steps", None)
        telemetry.append(dict(gen=g, n=len(iso.data),
                              loss=float(iso.losses[-1]),
                              t_gen=now - t_gen, t_total=now - t_start,
                              steps=int(cur_steps) if cur_steps else None))
        t_gen = now
        done = g + 1
        if out is not None and done % checkpoint_every == 0:
            save_campaign(iso, out, done, telemetry, results)
        if g % 50 == 0 or g == generations - 1:
            print(f"[{label}] gen {g}: n={len(iso.data)} "
                  f"loss={iso.losses[-1]:.5f} ({now - t_start:.0f}s)",
                  flush=True)
        if (adaptive_lag and done % check_every == 0
                and done < generations):
            lam = training_lag_headroom(iso)
            cur = int(iso.data.sim.steps)
            if lam > headroom and cur * lag_factor <= max_steps:
                new = cur * lag_factor
                print(f"[{label}] gen {g}: training-lag slow eigenvalue "
                      f"{lam:.5f} > headroom {headroom} — escalating lag "
                      f"{cur} -> {new} steps (warm-started)", flush=True)
                escalate_lag(iso, new, gen=100 + done,
                             sim_factory=build_sim)
                if results is not None:
                    results.setdefault("lag_escalations", []).append(
                        dict(gen=done, eig=lam, steps_from=cur,
                             steps_to=new))
            elif lam > headroom:
                print(f"[{label}] gen {g}: eigenvalue {lam:.5f} > "
                      f"headroom but max_steps reached", flush=True)
        if budget_s is not None:
            # the next generation predicted from the last one
            s_next = telemetry[-1]["t_gen"]
            if now - t_start + already_spent + s_next > budget_s:
                print(f"[{label}] budget {budget_s:.0f}s reached after "
                      f"{done} generations (next gen ~{s_next:.2f} s)",
                      flush=True)
                break
    return time.time() - t_start, done


def run_pilot(out, pilot_generations, iters, resamples, cutoff, nx, nk):
    """Train the pilot at the reference lag and save it (``pilot.pkl``,
    ``pilot.json``); returns the pilot."""
    import isokann_tpu_torch as itt

    sim0 = build_sim(100)
    print(f"{sim0.natoms} atoms, pilot lag {sim0.lagtime} ps", flush=True)
    pilot = itt.Iso(sim=sim0, nx=nx, nk=nk, gen=0,
                    opt=itt.AdamRegularized())
    t0 = time.time()
    campaign(pilot, pilot_generations, iters, resamples, cutoff,
             [], label="pilot")
    pilot.save(os.path.join(out, "pilot.pkl"))
    with open(os.path.join(out, "pilot.json"), "w") as f:
        json.dump({"pilot_wall_s": time.time() - t0,
                   "pilot_loss": float(pilot.losses[-1]),
                   "pilot_n": len(pilot.data)}, f, indent=1)
    print(f"pilot: saved ({time.time() - t0:.0f}s)", flush=True)
    return pilot


def run_sweep(out, pilot, ladder, sweep_nx, sweep_nk):
    """The implied-timescale lag sweep on the pilot.  The rows are
    written after every rung (``lag_sweep_phase.json``, keyed by the
    pilot file's time), so a relaunch runs only the rungs still missing,
    from the same start points (the sweep's seed is fixed).  Returns the
    file's content."""
    from isokann_tpu_torch.workflows import _recommend_lag

    path = os.path.join(out, "lag_sweep_phase.json")
    pilot_mtime = os.path.getmtime(os.path.join(out, "pilot.pkl"))
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        if old.get("pilot_mtime") == pilot_mtime:
            rows = old["rows"]
    done = {r["steps"] for r in rows}
    t0 = time.time()

    def dump(partial):
        rows.sort(key=lambda r: r["steps"])
        state = {"recommended_steps": _recommend_lag(rows), "rows": rows,
                 "wall_s": time.time() - t0, "pilot_mtime": pilot_mtime,
                 "partial": partial}
        with open(path, "w") as f:
            json.dump(state, f, indent=1)
        return state

    for s in sorted(int(s) for s in ladder):
        if s in done:
            continue
        _, rs = pilot.lag_sweep(steps=[s], nx=sweep_nx, nk=sweep_nk, gen=7)
        rows += rs
        dump(partial=True)
    state = dump(partial=False)
    print(f"sweep: recommended {state['recommended_steps']} "
          f"({time.time() - t0:.0f}s)", flush=True)
    return state


def main(generations=1000, iters=300, resamples=3, cutoff=2000,
         lag_sweep=True, steps=None, pilot_generations=50, out=None,
         sweep_only=False, ladder=None, sweep_nx=128, sweep_nk=8,
         nx=100, nk=8, budget_s=None, cktest_nx=24, cktest_nk=8,
         rr_nx=None, rr_nk=8, adaptive_lag=True, cpu=False,
         checkpoint_every=50):
    import numpy as np

    import isokann_tpu_torch as itt
    from isokann_tpu_torch.workflows import (_fit_koopman, cktest,
                                             rates_resolved)

    global DEVICE
    DEVICE = "cpu" if cpu else None
    out = out or os.path.join(OUT, f"{PDB_NAME}_production")
    os.makedirs(out, exist_ok=True)
    results = {}
    telemetry = []

    # ---- pilot at the reference lag + lag sweep ----------------------------
    if steps is None and lag_sweep:
        ladder = ladder or [100, 500, 2500, 12500, 62500]
        pilot_pkl = os.path.join(out, "pilot.pkl")
        if os.path.exists(pilot_pkl):
            pilot = itt.load(pilot_pkl, device=DEVICE)
        else:
            pilot = run_pilot(out, pilot_generations, iters, resamples,
                              cutoff, nx, nk)
        pj = os.path.join(out, "pilot.json")
        if os.path.exists(pj):
            with open(pj) as f:
                results.update(json.load(f))
        sw = run_sweep(out, pilot, ladder, sweep_nx, sweep_nk)
        results["lag_sweep"] = sw["rows"]
        results["lag_sweep_wall_s"] = sw["wall_s"]
        rec = sw["recommended_steps"]
        if rec is None:
            print("lag_sweep: no lag on the ladder resolved; using the "
                  "largest", flush=True)
            rec = ladder[-1]
        steps = rec
        print(f"lag_sweep: production lag = {steps} steps", flush=True)
        try:
            from isokann_tpu_torch.utils.plots import plot_lag_sweep
            _close(plot_lag_sweep(results["lag_sweep"],
                                  out=os.path.join(out, "lag_sweep.png")))
        except Exception as e:
            results["lag_sweep_plot_error"] = repr(e)
        if sweep_only:
            with open(os.path.join(out, "lag_sweep.json"), "w") as f:
                json.dump(results, f, indent=1)
            print(json.dumps(results, indent=1), flush=True)
            return results
    elif steps is None:
        steps = 100

    # ---- production campaign at the selected lag ---------------------------
    start_gen = 0
    resumed = load_campaign(out, device=DEVICE)
    if resumed is not None:
        iso, meta = resumed
        start_gen = int(meta["done"])
        telemetry.extend(meta.get("telemetry", []))
        if meta.get("lag_escalations"):
            results["lag_escalations"] = meta["lag_escalations"]
        sim = iso.data.sim
        already_spent = (float(meta["telemetry"][-1]["t_total"])
                         if meta.get("telemetry") else 0.0)
        print(f"resuming campaign from checkpoint: gen {start_gen}, "
              f"lag {sim.steps} steps, {already_spent:.0f}s of budget "
              f"already spent", flush=True)
    else:
        sim = build_sim(steps)
        print(f"{sim.natoms} atoms, production lag {sim.lagtime} ps",
              flush=True)
        iso = itt.Iso(sim=sim, nx=nx, nk=nk, gen=0,
                      opt=itt.AdamRegularized())
        already_spent = 0.0

    wall, gens_run = campaign(iso, generations, iters, resamples, cutoff,
                              telemetry, label="prod", budget_s=budget_s,
                              adaptive_lag=adaptive_lag, results=results,
                              out=out, start_gen=start_gen,
                              checkpoint_every=checkpoint_every,
                              already_spent=already_spent)
    # lag escalations replace the simulation: the analysis runs at the lag
    # the campaign ended on
    sim = iso.data.sim
    steps = int(sim.steps)
    gens_new = max(1, gens_run - start_gen)
    print(f"total {wall:.1f}s for {gens_new} generations this process "
          f"({wall / gens_new * 1e3:.0f} ms/gen, {gens_run} total), "
          f"final lag {steps} steps", flush=True)

    # ---- analysis ----------------------------------------------------------
    iso.save(os.path.join(out, "iso_final.pkl"))

    def checkpoint():
        with open(os.path.join(out, "results.json"), "w") as f:
            json.dump(dict(results=results, telemetry=telemetry[-100:]), f,
                      indent=1)

    results.update(generations=gens_run, generations_requested=generations,
                   iters_per_gen=iters, steps=steps, lag_ps=sim.lagtime,
                   wall_s=wall, ms_per_gen=wall / gens_new * 1e3,
                   resumed_from_gen=start_gen, n_final=len(iso.data),
                   loss_final=float(iso.losses[-1]))
    chi = iso.chis().double().cpu().numpy()
    kchi = iso.koopman().double().cpu().numpy()
    _, eigs = _fit_koopman(chi, kchi)
    results["koopman_eigs"] = np.sort(np.real(eigs))[::-1].tolist()
    results["rates_per_ps"] = np.asarray(iso.rates()).tolist()
    results["exit_rates"] = np.asarray(iso.exit_rates()).tolist()
    results["chi_exit_rate"] = float(np.asarray(iso.chi_exit_rate()))
    checkpoint()
    # the trained chi's rates at the campaign lag and one 5x rung above
    # it: the implied-timescale plateau across two resolved rungs is what
    # certifies the exit rates
    rr_lags = ([steps, steps * 5] if steps * 5 <= 62500
               else [max(100, steps // 5), steps])
    Qr, row, rrows = rates_resolved(
        iso, lags=rr_lags, nx=min(rr_nx or 100, len(iso.data)), nk=rr_nk,
        gen=13, return_rows=True)
    results["rates_resolved_rows"] = [
        {k: v for k, v in r.items() if k != "K"} for r in rrows]
    if Qr is not None:
        results["rates_resolved_per_ps"] = np.asarray(Qr).tolist()
        results["rates_resolved_exit"] = (-np.diag(Qr)).tolist()
        results["rates_resolved_lag_steps"] = row["steps"]
        results["rates_resolved_eigs"] = row["eigs"]
        resolved = [r for r in rrows if r.get("exit_rates")]
        if len(resolved) >= 2:
            a = np.asarray(resolved[0]["exit_rates"])
            b = np.asarray(resolved[1]["exit_rates"])
            results["rates_plateau_ratio"] = (b / a).tolist()
    checkpoint()
    if cktest_nx:
        # Chapman-Kolmogorov test at the campaign lag
        t0 = time.time()
        ck_factors = tuple(k for k in (2, 4) if steps * k <= 125000) or (2,)
        ck_ok, ck_rows = cktest(iso, steps=steps, factors=ck_factors,
                                nx=int(cktest_nx), nk=int(cktest_nk), gen=11)
        results["cktest_ok"] = bool(ck_ok)
        results["cktest_base_steps"] = steps
        results["cktest_rows"] = [
            {k: v for k, v in r.items() if k != "dev"} for r in ck_rows]
        results["cktest_max_abs_dev"] = max(
            r["max_abs_dev"] for r in ck_rows)
        results["cktest_wall_s"] = time.time() - t0
        try:
            from isokann_tpu_torch.utils.plots import plot_cktest
            _close(plot_cktest(ck_rows, out=os.path.join(out, "cktest.png")))
        except Exception as e:
            results["cktest_plot_error"] = repr(e)
        checkpoint()
    reactive_path_stage(iso, out, results)
    try:
        from isokann_tpu_torch.utils.plots import plot_chi, plot_training
        _close(plot_training(iso, out=os.path.join(out, "training.png")))
        _close(plot_chi(iso, out=os.path.join(out, "chi.png")))
    except Exception as e:
        results["plot_error"] = repr(e)
    checkpoint()
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--generations", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--no-lag-sweep", action="store_true")
    ap.add_argument("--steps", type=int, default=None,
                    help="skip the sweep and use this lag directly")
    ap.add_argument("--pilot-generations", type=int, default=50)
    ap.add_argument("--sweep-only", action="store_true",
                    help="stop after the pilot + lag sweep")
    ap.add_argument("--ladder", type=str, default=None,
                    help="comma-separated lag ladder in steps")
    ap.add_argument("--sweep-nx", type=int, default=128)
    ap.add_argument("--sweep-nk", type=int, default=8)
    ap.add_argument("--nx", type=int, default=100)
    ap.add_argument("--nk", type=int, default=8)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--cktest-nx", type=int, default=24,
                    help="start points for the CK test at the campaign "
                         "lag (0 disables)")
    ap.add_argument("--cktest-nk", type=int, default=8)
    ap.add_argument("--rr-nx", type=int, default=None,
                    help="start points for the resolved-rate rungs "
                         "(default min(100, n))")
    ap.add_argument("--rr-nk", type=int, default=8)
    ap.add_argument("--no-adaptive-lag", action="store_true",
                    help="no mid-campaign lag escalation when the "
                         "training-lag eigenvalue passes 0.98")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="wall budget for the campaign; stops early "
                         "(recorded) once s/gen says it would be exceeded")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain versions of the "
                         "kernels)")
    ap.add_argument("--sequence", type=str, default=TC5B,
                    help="one-letter peptide sequence (default: trp-cage "
                         "TC5B); built and minimized in OBC2")
    ap.add_argument("--name", type=str, default="trpcage",
                    help="system name: the structure is cached at "
                         "out/torch/<name>.pdb and the default artifact "
                         "directory is out/torch/<name>_production")
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="campaign checkpoint interval (generations)")
    args = ap.parse_args()
    SEQUENCE = args.sequence
    PDB_NAME = args.name
    main(generations=args.generations, iters=args.iters,
         lag_sweep=not args.no_lag_sweep, steps=args.steps,
         pilot_generations=args.pilot_generations,
         sweep_only=args.sweep_only,
         ladder=([int(x) for x in args.ladder.split(",")]
                 if args.ladder else None),
         sweep_nx=args.sweep_nx, sweep_nk=args.sweep_nk,
         nx=args.nx, nk=args.nk, budget_s=args.budget_s, out=args.out,
         cktest_nx=args.cktest_nx, cktest_nk=args.cktest_nk,
         rr_nx=args.rr_nx, rr_nk=args.rr_nk,
         adaptive_lag=not args.no_adaptive_lag, cpu=args.cpu,
         checkpoint_every=args.checkpoint_every)
