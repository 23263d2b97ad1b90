"""Serialized OpenMM System XML import / export.

Counterpart of ``isokann_tpu/md/openmm_xml.py``.  An OpenMM ``System``
dumped by ``XmlSerializer.serialize(system)`` carries fully resolved
per-particle and per-term parameters (charges, LJ, bonds, angles,
torsions, exceptions, constraints, GBSA-OBC, CMAP, virtual sites), so
importing it reproduces that force field with no lookup:

    system, constraints, meta = load_system_xml("sys.xml")
    sim = MDSimulation.from_system(system, x0, constraint_pairs=constraints)

The system is built through ``system.system_from_tables`` with its
tensors on ``device`` (the GPU unless the caller names another); average
and out-of-plane virtual sites go onto the ``md/vsites.py`` tables.
``save_system_xml`` writes the same schema from an ``MDSystem`` (the same
text as the JAX package's for equal tables); ``load_state_xml`` reads a
serialized ``State``.

Representation notes:
- OpenMM harmonic k (E = k/2 dx^2) is halved into the Amber convention
  used by ``MDSystem`` (E = k dx^2).
- Exceptions are stored as explicit (chargeProd, sigma, epsilon); the
  engine represents them as *scales* on the combined atomic parameters.
  For force-field-generated systems the two are identical (OpenMM builds
  exceptions from the same Lorentz-Berthelot combination); pairs that
  deviate raise a warning with the worst mismatch.
"""

from __future__ import annotations

import math
import warnings
import xml.etree.ElementTree as ET

import numpy as np

from .amberio import _host

SIGMA_TO_RMIN = 2.0 ** (1.0 / 6.0)

# NonbondedForce method enum (openmm/serialization/NonbondedForceProxy)
_NB_METHODS = {0: "NoCutoff", 1: "CutoffNonPeriodic", 2: "CutoffPeriodic",
               3: "Ewald", 4: "PME", 5: "LJPME"}
_NB_METHODS_INV = {v: k for k, v in _NB_METHODS.items()}


def _children(el, tag):
    sub = el.find(tag)
    return [] if sub is None else list(sub)


def _get(el, *names, default=None, cast=float):
    for nm in names:
        v = el.get(nm)
        if v is not None:
            return cast(v)
    return default


def load_system_xml(path_or_text: str, dense_pairs="auto", device=None):
    """Parse serialized OpenMM System XML.

    Returns ``(system, constraints, meta)``: an ``MDSystem`` built via
    ``system_from_tables``; ``constraints`` a list of (i, j, d_nm) from the
    ``<Constraints>`` block (feed to ``ConstraintSet(pairs=...)``); meta a
    dict with keys ``barostat`` ((pressure_bar, temp_K) or None) and
    ``skipped_forces``.  ``dense_pairs`` as in ``system_from_tables``
    (False: the O(n) cell-list layout of the neighbor route, for a
    periodic system).  The JAX package's reader has no such argument and
    always takes the default; the port's ``system_from_prmtop`` has the
    same one, and both values give the same energies.  The system's
    tensors land on ``device`` (the GPU unless the caller names
    another)."""
    from .system import system_from_tables

    text = path_or_text
    if "\n" not in path_or_text and not path_or_text.lstrip().startswith("<"):
        with open(path_or_text) as f:
            text = f.read()
    root = ET.fromstring(text)
    if root.tag != "System":
        raise ValueError(f"not a serialized System (root <{root.tag}>)")

    masses = []
    vsites = []                                  # (site, parents, weights)
    for i, p in enumerate(root.find("Particles")):
        masses.append(_get(p, "mass"))
        vs = p.find("VirtualSite")
        if vs is None:
            continue
        vt = vs.get("type")
        if vt in ("average2", "average3"):
            np_ = 2 if vt == "average2" else 3
            parents = [int(_get(vs, f"particle{k}", f"p{k}", cast=int))
                       for k in range(1, np_ + 1)]
            weights = [float(_get(vs, f"weight{k}", f"w{k}"))
                       for k in range(1, np_ + 1)]
            vsites.append((i, parents, weights, 0.0))
        elif vt == "outOfPlane":
            parents = [int(_get(vs, f"particle{k}", f"p{k}", cast=int))
                       for k in (1, 2, 3)]
            w12 = float(_get(vs, "weight12"))
            w13 = float(_get(vs, "weight13"))
            wcr = float(_get(vs, "weightCross", "weightcross"))
            vsites.append((i, parents, [1.0 - w12 - w13, w12, w13], wcr))
        else:
            raise ValueError(
                f"virtual site type {vt!r} is not supported (average2/"
                f"average3/outOfPlane; localCoords sites need an engine "
                f"extension)")
    n = len(masses)

    box = None
    pbv = root.find("PeriodicBoxVectors")
    if pbv is not None:
        a = pbv.find("A"); b = pbv.find("B"); c = pbv.find("C")
        av = [_get(a, "x"), _get(a, "y"), _get(a, "z")]
        bv = [_get(b, "x"), _get(b, "y"), _get(b, "z")]
        cv = [_get(c, "x"), _get(c, "y"), _get(c, "z")]
        off = abs(av[1]) + abs(av[2]) + abs(bv[0]) + abs(bv[2]) \
            + abs(cv[0]) + abs(cv[1])
        if off > 1e-6:
            raise ValueError("only rectangular boxes are supported")
        box = (av[0], bv[1], cv[2])

    constraints = []
    cblock = root.find("Constraints")
    if cblock is not None:
        for c in cblock:
            constraints.append((int(c.get("p1")), int(c.get("p2")),
                                _get(c, "d")))

    bonds, angles, torsions = [], [], []
    charges = np.zeros(n)
    sigma = np.zeros(n)
    eps = np.zeros(n)
    exceptions = []
    method = "NoCutoff"
    cutoff = 1.0
    eps_rf = 78.5
    ewald_tol = 5e-4
    dispersion = True
    uses_pbc = box is not None
    gb_radii = gb_scales = None
    barostat = None
    skipped = []
    seen_nb = False
    cmap_grids: list = []
    cmap_terms: list = []

    for force in root.find("Forces"):
        ftype = force.get("type")
        if ftype == "HarmonicBondForce":
            for e in _children(force, "Bonds"):
                bonds.append((int(e.get("p1")), int(e.get("p2")),
                              _get(e, "k") / 2.0, _get(e, "d", "length")))
        elif ftype == "HarmonicAngleForce":
            for e in _children(force, "Angles"):
                angles.append((int(e.get("p1")), int(e.get("p2")),
                               int(e.get("p3")), _get(e, "k") / 2.0,
                               _get(e, "a", "angle")))
        elif ftype == "PeriodicTorsionForce":
            for e in _children(force, "Torsions"):
                torsions.append((int(e.get("p1")), int(e.get("p2")),
                                 int(e.get("p3")), int(e.get("p4")),
                                 _get(e, "k"),
                                 _get(e, "phase"),
                                 _get(e, "periodicity", cast=float)))
        elif ftype == "NonbondedForce":
            seen_nb = True
            m = _get(force, "method", cast=int, default=0)
            method = _NB_METHODS.get(m, "NoCutoff")
            cutoff = _get(force, "cutoff", default=1.0)
            eps_rf = _get(force, "rfDielectric", default=78.5)
            ewald_tol = _get(force, "ewaldTolerance", default=5e-4)
            dispersion = bool(_get(force, "dispersionCorrection",
                                   cast=int, default=1))
            if _get(force, "useSwitchingFunction", cast=int, default=0):
                warnings.warn("switching function not supported; using a "
                              "hard cutoff")
            for i, e in enumerate(force.find("Particles")):
                charges[i] = _get(e, "q", "charge", default=0.0)
                sigma[i] = _get(e, "sig", "sigma", default=0.0)
                eps[i] = _get(e, "eps", "epsilon", default=0.0)
            for e in _children(force, "Exceptions"):
                exceptions.append((int(e.get("p1")), int(e.get("p2")),
                                   _get(e, "q", "chargeProd", default=0.0),
                                   _get(e, "sig", "sigma", default=0.0),
                                   _get(e, "eps", "epsilon", default=0.0)))
        elif ftype == "CMAPTorsionForce":
            # grid convention: OpenMM tabulates from angle 0 (energy
            # index = phi + R*psi, phi fastest); the engine's grids start
            # at -pi, so roll by R/2 on both axes.  Our own exporter
            # writes the same 0-origin convention for round-trip parity.
            for mel in _children(force, "Maps"):
                vals = mel.get("energy") or (mel.text or "")
                g = np.asarray([float(v) for v in vals.split()])
                R = int(round(math.sqrt(len(g))))
                if R * R != len(g):
                    raise ValueError("CMAP map is not square")
                g = g.reshape(R, R, order="F")       # [phi, psi]
                cmap_grids.append(np.roll(g, (R // 2, R // 2), (0, 1)))
            for e in _children(force, "Torsions"):
                cmap_terms.append(
                    (int(_get(e, "map", cast=int)),
                     [int(_get(e, f"p{k}", f"a{k}", cast=int))
                      for k in range(1, 9)]))
        elif ftype == "GBSAOBCForce":
            gb_radii = np.zeros(n)
            gb_scales = np.zeros(n)
            for i, e in enumerate(force.find("Particles")):
                gb_radii[i] = _get(e, "r", "radius")
                gb_scales[i] = _get(e, "scale", "scalingFactor")
        elif ftype == "MonteCarloBarostat":
            barostat = (_get(force, "pressure", default=1.01325),
                        _get(force, "temperature", default=300.0))
        elif ftype in ("CMMotionRemover",):
            pass
        else:
            skipped.append(ftype)
    if skipped:
        warnings.warn(f"unsupported forces skipped: {skipped}")
    if not seen_nb:
        warnings.warn("no NonbondedForce in the serialized system")

    rmin_half = sigma * SIGMA_TO_RMIN / 2.0
    # eps==0 particles (TIP3P hydrogens, M sites) get rmin_half 0 so the
    # dispersion/LJPME sums see a true zero-LJ atom
    rmin_half = np.where(eps > 0.0, rmin_half, 0.0)

    # exceptions -> scales on the combined parameters
    excl_idx, excl_qq, excl_lj = [], [], []
    worst = 0.0
    for (i, j, qprod, sig_ex, eps_ex) in exceptions:
        qij = charges[i] * charges[j]
        if qprod == 0.0:
            wq = 0.0
        elif abs(qij) > 1e-12:
            wq = qprod / qij
        else:
            wq = 0.0
            worst = max(worst, abs(qprod))
        eij = math.sqrt(eps[i] * eps[j])
        if eps_ex == 0.0:
            wl = 0.0
        elif eij > 1e-12:
            wl = eps_ex / eij
            rm_comb = rmin_half[i] + rmin_half[j]
            rm_ex = sig_ex * SIGMA_TO_RMIN
            if rm_comb > 0:
                worst = max(worst, abs(rm_ex - rm_comb))
        else:
            wl = 0.0
            worst = max(worst, eps_ex)
        excl_idx.append((min(i, j), max(i, j)))
        excl_qq.append(wq)
        excl_lj.append(wl)
    if worst > 1e-6:
        warnings.warn(f"some exceptions are not representable as "
                      f"combination-rule scales (worst deviation "
                      f"{worst:.2e}); energies will differ")

    bonds = np.asarray(bonds, float).reshape(-1, 4)
    angles = np.asarray(angles, float).reshape(-1, 5)
    torsions = np.asarray(torsions, float).reshape(-1, 7)

    if method in ("CutoffPeriodic", "Ewald", "PME", "LJPME") and not uses_pbc:
        raise ValueError(f"method {method} but no periodic box")
    if method == "LJPME":
        warnings.warn("LJPME import: dispersion amplitudes are rebuilt "
                      "from the per-atom LJ (geometric C6)")

    cmap_kw = {}
    if cmap_terms:
        cmap_kw = dict(
            cmap_idx=[a for _, a in cmap_terms],
            cmap_type=[t for t, _ in cmap_terms],
            cmap_grids=cmap_grids)
    system = system_from_tables(
        masses=masses, charges=charges, rmin_half=rmin_half,
        eps=eps, **cmap_kw,
        bond_idx=bonds[:, :2].astype(np.int32), bond_k=bonds[:, 2],
        bond_r0=bonds[:, 3],
        angle_idx=angles[:, :3].astype(np.int32), angle_k=angles[:, 3],
        angle_t0=angles[:, 4],
        dih_idx=torsions[:, :4].astype(np.int32), dih_pk=torsions[:, 4],
        dih_phase=torsions[:, 5], dih_n=torsions[:, 6],
        excl_idx=np.asarray(excl_idx, np.int32).reshape(-1, 2),
        excl_qq=excl_qq, excl_lj=excl_lj,
        method=method, cutoff=cutoff, eps_rf=eps_rf, box=box,
        gb_radii=gb_radii, gb_scales=gb_scales,
        ewald_tol=ewald_tol, dispersion_correction=dispersion,
        dense_pairs=dense_pairs, device=device)
    if vsites:
        from .vsites import attach_vsites
        kmax = max(len(p) for _, p, _, _ in vsites)
        par = np.zeros((len(vsites), kmax), np.int32)
        wts = np.zeros((len(vsites), kmax))
        for r, (_, p, w, _) in enumerate(vsites):
            par[r, :len(p)] = p
            par[r, len(p):] = p[0]
            wts[r, :len(w)] = w
        system = attach_vsites(system, [s for s, _, _, _ in vsites],
                               par, wts,
                               vs_cross=[c for _, _, _, c in vsites])
    meta = dict(barostat=barostat, skipped_forces=skipped)
    return system, constraints, meta


def load_state_xml(path_or_text: str):
    """Parse a serialized OpenMM State (``simulation.saveState(file)`` /
    ``XmlSerializer.serialize(state)``).

    Returns ``(coords (n, 3) [nm], velocities (n, 3) [nm/ps] or None,
    box (3,) [nm] or None)`` — the natural companion of
    ``load_system_xml`` for moving a running reference simulation here.
    """
    text = path_or_text
    if "\n" not in path_or_text and not path_or_text.lstrip().startswith("<"):
        with open(path_or_text) as f:
            text = f.read()
    root = ET.fromstring(text)
    if root.tag != "State":
        raise ValueError(f"not a serialized State (root <{root.tag}>)")

    def vectors(tag):
        el = root.find(tag)
        if el is None:
            return None
        return np.asarray([[_get(p, "x"), _get(p, "y"), _get(p, "z")]
                           for p in el], float)

    coords = vectors("Positions")
    vel = vectors("Velocities")
    box = None
    pbv = root.find("PeriodicBoxVectors")
    if pbv is not None:
        a, b, c = pbv.find("A"), pbv.find("B"), pbv.find("C")
        box = np.asarray([_get(a, "x"), _get(b, "y"), _get(c, "z")])
    return coords, vel, box


def save_system_xml(system, path: str | None = None, constraints=None):
    """Serialize an MDSystem as OpenMM System XML (returns the text).

    The output loads with ``XmlSerializer.deserialize`` so external OpenMM
    installations can compute reference energies for any system built
    here.  ``constraints``: optional (i, j, d_nm) list."""
    charges = _host(system.charges, float)
    rmin_half = _host(system.rmin_half, float)
    eps = _host(system.eps, float)
    masses = _host(system.masses, float)
    n = len(masses)

    root = ET.Element("System", openmmVersion="8.1.1", type="System",
                      version="1")
    pbv = ET.SubElement(root, "PeriodicBoxVectors")
    box = system.box if system.box is not None else (2.0, 2.0, 2.0)
    for name, v in zip("ABC", np.diag(box)):
        ET.SubElement(pbv, name, x=repr(float(v[0])), y=repr(float(v[1])),
                      z=repr(float(v[2])))
    from .vsites import has_vsites, _has_oop
    site_rows = {}
    if has_vsites(system):
        g = _host(system.vs_gather, int)
        w = _host(system.vs_w, float)
        wc = (_host(system.vs_wc, float) if _has_oop(system)
              else np.zeros(len(masses)))
        for s in _host(system.vs_idx, int):
            site_rows[int(s)] = (g[s], w[s], wc[s])
    parts = ET.SubElement(root, "Particles")
    for i, m in enumerate(masses):
        pe = ET.SubElement(parts, "Particle", mass=repr(float(m)))
        if i in site_rows:
            g, w, wci = site_rows[i]
            if wci != 0.0:
                attrs = {"type": "outOfPlane",
                         "weight12": repr(float(w[1])),
                         "weight13": repr(float(w[2])),
                         "weightCross": repr(float(wci))}
                for k in (1, 2, 3):
                    attrs[f"particle{k}"] = str(int(g[k - 1]))
                ET.SubElement(pe, "VirtualSite", **attrs)
                continue
            # collapse padded duplicate parents
            seen = {}
            for p, wt in zip(g, w):
                seen[int(p)] = seen.get(int(p), 0.0) + float(wt)
            items = [(p, wt) for p, wt in seen.items() if wt != 0.0]
            attrs = {"type": "average2" if len(items) == 2 else "average3"}
            for k, (p, wt) in enumerate(items, 1):
                attrs[f"particle{k}"] = str(p)
                attrs[f"weight{k}"] = repr(wt)
            ET.SubElement(pe, "VirtualSite", **attrs)
    cons = ET.SubElement(root, "Constraints")
    for (i, j, d) in (constraints or []):
        ET.SubElement(cons, "Constraint", d=repr(float(d)),
                      p1=str(int(i)), p2=str(int(j)))
    forces = ET.SubElement(root, "Forces")

    periodic = "1" if (system.box is not None and system.method in
                       ("CutoffPeriodic", "Ewald", "PME", "LJPME")) else "0"
    f = ET.SubElement(forces, "Force", forceGroup="0",
                      type="HarmonicBondForce", usesPeriodic="0",
                      version="2", name="HarmonicBondForce")
    bl = ET.SubElement(f, "Bonds")
    for (i, j), k, r0 in zip(_host(system.bond_idx, int),
                             _host(system.bond_k, float),
                             _host(system.bond_r0, float)):
        ET.SubElement(bl, "Bond", d=repr(float(r0)), k=repr(float(2.0 * k)),
                      p1=str(int(i)), p2=str(int(j)))
    f = ET.SubElement(forces, "Force", forceGroup="0",
                      type="HarmonicAngleForce", usesPeriodic="0",
                      version="2", name="HarmonicAngleForce")
    al = ET.SubElement(f, "Angles")
    for (i, j, k3), k, t0 in zip(_host(system.angle_idx, int),
                                 _host(system.angle_k, float),
                                 _host(system.angle_t0, float)):
        ET.SubElement(al, "Angle", a=repr(float(t0)), k=repr(float(2.0 * k)),
                      p1=str(int(i)), p2=str(int(j)), p3=str(int(k3)))
    f = ET.SubElement(forces, "Force", forceGroup="0",
                      type="PeriodicTorsionForce", usesPeriodic="0",
                      version="2", name="PeriodicTorsionForce")
    tl = ET.SubElement(f, "Torsions")
    for (i, j, k3, l), pk, ph, per in zip(
            _host(system.dih_idx, int),
            _host(system.dih_pk, float),
            _host(system.dih_phase, float),
            _host(system.dih_n, float)):
        ET.SubElement(tl, "Torsion", k=repr(float(pk)),
                      p1=str(int(i)), p2=str(int(j)), p3=str(int(k3)),
                      p4=str(int(l)), periodicity=str(int(per)),
                      phase=repr(float(ph)))

    f = ET.SubElement(
        forces, "Force", alpha=repr(float(system.ewald_alpha)),
        cutoff=repr(float(system.cutoff)),
        dispersionCorrection="1" if system.use_dispersion else "0",
        ewaldTolerance="0.0005", exceptionsUsePeriodic="0",
        forceGroup="0", includeDirectSpace="1", ljAlpha="0",
        method=str(_NB_METHODS_INV[system.method]),
        name="NonbondedForce", nx="0", ny="0", nz="0",
        recipForceGroup="-1", rfDielectric=repr(float(system.eps_rf)),
        switchingDistance="-1", type="NonbondedForce",
        useSwitchingFunction="0", version="4")
    ET.SubElement(f, "GlobalParameters")
    ET.SubElement(f, "ParticleOffsets")
    ET.SubElement(f, "ExceptionOffsets")
    pl = ET.SubElement(f, "Particles")
    for i in range(n):
        sig = (2.0 * rmin_half[i]) / SIGMA_TO_RMIN
        if eps[i] == 0.0 and sig == 0.0:
            sig = 0.1                            # OpenMM zero-LJ idiom
        ET.SubElement(pl, "Particle", eps=repr(float(eps[i])),
                      q=repr(float(charges[i])), sig=repr(float(sig)))
    el = ET.SubElement(f, "Exceptions")
    for (i, j), wq, wl in zip(_host(system.excl_idx, int),
                              _host(system.excl_qq, float),
                              _host(system.excl_lj, float)):
        qprod = wq * charges[i] * charges[j]
        eij = wl * math.sqrt(eps[i] * eps[j])
        sig_ex = (rmin_half[i] + rmin_half[j]) / SIGMA_TO_RMIN
        if sig_ex == 0.0:
            sig_ex = 0.1
        ET.SubElement(el, "Exception", eps=repr(float(eij)),
                      p1=str(int(i)), p2=str(int(j)),
                      q=repr(float(qprod)), sig=repr(float(sig_ex)))

    from .cmap import has_cmap
    if has_cmap(system):
        f = ET.SubElement(forces, "Force", forceGroup="0",
                          name="CMAPTorsionForce", type="CMAPTorsionForce",
                          usesPeriodic="0", version="2")
        ml = ET.SubElement(f, "Maps")
        coefs = _host(system.cmap_coefs, float)
        R = coefs.shape[1]
        for t in range(coefs.shape[0]):
            grid = coefs[t, :, :, 0, 0]                   # [phi, psi], -pi
            g0 = np.roll(grid, (-(R // 2), -(R // 2)), (0, 1))  # 0-origin
            ET.SubElement(ml, "Map", energy=" ".join(
                repr(float(v)) for v in g0.reshape(-1, order="F")))
        tl = ET.SubElement(f, "Torsions")
        for r8, t in zip(_host(system.cmap_idx, int),
                         _host(system.cmap_type, int)):
            attrs = {"map": str(int(t))}
            for k in range(8):
                attrs[f"p{k + 1}"] = str(int(r8[k]))
            ET.SubElement(tl, "Torsion", **attrs)

    if system.implicit == "obc2" and system.gb_radii.shape[0] == n:
        f = ET.SubElement(forces, "Force", cutoff=repr(float(system.cutoff)),
                          forceGroup="0", method="0", name="GBSAOBCForce",
                          soluteDielectric="1", solventDielectric="78.5",
                          surfaceAreaEnergy="2.25936", type="GBSAOBCForce",
                          usesPeriodic="0", version="2")
        pl = ET.SubElement(f, "Particles")
        radii, scales = _host(system.gb_radii), _host(system.gb_scales)
        for i in range(n):
            ET.SubElement(pl, "Particle",
                          q=repr(float(charges[i])),
                          r=repr(float(radii[i])),
                          scale=repr(float(scales[i])))

    ET.indent(root)
    text = ET.tostring(root, encoding="unicode", xml_declaration=True)
    if path is not None:
        with open(path, "w") as fh:
            fh.write(text)
    return text
