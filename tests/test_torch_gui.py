"""The port's dashboards on the CPU, as ``tests/test_utils_extra.py:
59-155`` drives the JAX package's: the live page and its images, the
training loop behind ``livegui``, and the interactive panel (its CSRF
token, apply, pause, the molecule viewer and its JSON).  Every server
binds a free port (``port=0``), every wait has a deadline, and every
server and thread is stopped in ``finally``."""

import json
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

import isokann_tpu_torch as itt
from isokann_tpu_torch.utils.gui import InteractiveGui

torch.set_num_threads(1)

PNG = b"\x89PNG\r\n\x1a\n"


def _get(port, path, timeout=60):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=timeout).read()


def _post(port, form, timeout=60):
    data = urllib.parse.urlencode(form).encode()
    return urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/control", data=data), timeout=timeout)


@pytest.fixture(scope="module")
def md_iso():
    sim = itt.MDSimulation(steps=5, device="cpu")
    iso = itt.Iso(sim=sim, nx=8, nk=2, gen=0, minibatch=0,
                  opt=itt.AdamRegularized())
    iso.run(5)
    return iso


def test_dashboard_server(md_iso):
    srv = itt.serve_dashboard(md_iso, port=0)
    port = srv.server_address[1]
    try:
        html = _get(port, "/").decode()
        assert "isokann_tpu_torch" in html and "iterations: 5" in html
        assert '<img src="/rama.png"/>' in html
        assert _get(port, "/training.png")[:8] == PNG
        assert _get(port, "/rama.png")[:8] == PNG
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nothing")
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()


def test_livegui_trains_and_stops(md_iso):
    """``livegui`` trains the iterations in chunks and stops its server."""
    n0 = len(md_iso.losses)
    before = set(threading.enumerate())
    itt.livegui(md_iso, iterations=4, chunk=3, port=0)
    assert len(md_iso.losses) == n0 + 4
    deadline = time.monotonic() + 10
    while (set(threading.enumerate()) - before
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert not (set(threading.enumerate()) - before)


def test_interactive_gui_controls():
    """The panel builds and trains from form posts on the CPU (the
    reference GUI's sliders, ext/MakieExt.jl:18-80)."""
    gui = InteractiveGui(steps=10, nx=8, nk=2, chunk=5, device="cpu")
    srv = gui.serve(port=0)
    port = srv.server_address[1]
    try:
        page = _get(port, "/").decode()
        assert "Apply" in page and "nx" in page and "no run yet" in page
        # posts without the per-session token are refused
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, dict(action="toggle"))
        assert e.value.code == 403
        token = re.search(r'name="token" value="([^"]+)"', page).group(1)
        r = _post(port, dict(pdb="", steps=10, temp=310.0, nx=8, nk=2,
                             opt="adam", lr=1e-3, reg=1e-4, kde=0,
                             action="apply", token=token))
        assert r.status == 200
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if gui.iso is not None and len(gui.iso.losses) >= 5:
                break
            time.sleep(0.1)
        assert gui.error is None
        assert gui.iso is not None and len(gui.iso.losses) >= 5
        assert gui.iso.data.coords.device.type == "cpu"
        _post(port, dict(action="toggle", token=token))
        assert not gui.running
        page = _get(port, "/").decode()
        assert "Resume" in page and "iterations:" in page
        assert _get(port, "/training.png")[:8] == PNG
        # the 3-D molecule panel (reference plotmol, ext/MakieExt.jl:
        # 209-310): the viewer page and its frames, bonds and chi
        mol = _get(port, "/mol").decode()
        assert "canvas" in mol and "mol.json" in mol
        d = json.loads(_get(port, "/mol.json"))
        assert len(d["frames"]) == len(d["chi"]) == len(gui.iso.data) > 0
        assert len(d["frames"][0]) == 22 and len(d["bonds"]) == 21
        assert d["chi_lo"] <= d["chi_hi"]
    finally:
        gui.shutdown(timeout=60)
    assert not gui._worker.is_alive()


def test_interactive_gui_helper_and_apply():
    """``interactive_gui`` starts the panel; ``apply`` casts the fields,
    ignores bad ones and toggles only a built learner."""
    gui = itt.interactive_gui(port=0, steps=4, nx=4, nk=1, device="cpu")
    try:
        assert gui._srv.server_address[1] > 0
        gui.apply({"nx": ["6"], "lr": ["bad"], "action": ["toggle"]})
        assert gui.cfg["nx"] == 6 and gui.cfg["lr"] == 1e-3
        assert not gui.running and gui.iso is None
    finally:
        gui.shutdown(timeout=60)
    assert not gui._worker.is_alive()
