"""Live training dashboard in the browser; counterpart of
``isokann_tpu/utils/gui.py`` (the reference's Bonito/WGLMakie GUI,
``ext/MakieExt.jl:18-80``), on the standard library's ``http.server``.

``serve_dashboard(iso)`` serves an auto-refreshing page with the training
dashboard (and the Ramachandran plot of an MD system) from a background
thread; ``livegui(iso, ...)`` trains meanwhile; ``InteractiveGui`` adds a
form that (re)builds the simulation and the learner and a training
thread.  The images need matplotlib.  Servers bind to 127.0.0.1 by
default; ``port=0`` takes a free port (``srv.server_address[1]``).
"""

from __future__ import annotations

import html
import http.server
import io
import json
import secrets
import threading
import urllib.parse

import numpy as np
import torch

# pyplot is not thread-safe: one figure is drawn at a time
_RENDER_LOCK = threading.Lock()

_PAGE = """<!doctype html>
<html><head><title>isokann_tpu_torch live dashboard</title>
<meta http-equiv="refresh" content="{refresh}">
<style>body{{font-family:sans-serif;background:#111;color:#eee;text-align:center}}
img{{max-width:95%;background:#fff;margin:8px;border-radius:6px}}</style></head>
<body><h3>isokann_tpu_torch &mdash; live training</h3>
<div>{status}</div>
<img src="/training.png"/><br/>{rama}
</body></html>"""


def _png(fig):
    import matplotlib.pyplot as plt
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=100)
    plt.close(fig)
    return buf.getvalue()


def _render(iso, want_rama):
    """{"/training.png": bytes, "/rama.png": bytes (an MD system)}."""
    from .plots import plot_training, scatter_ramachandran

    with _RENDER_LOCK:
        out = {"/training.png": _png(plot_training(iso))}
        if want_rama:
            try:
                out["/rama.png"] = _png(scatter_ramachandran(iso))
            except IndexError:      # a molecule without backbone dihedrals
                pass
    return out


# 3-D molecule panel (reference ``plotmol``, ext/MakieExt.jl:209-310):
# frames + bonds + per-frame chi served as JSON, rendered by a
# dependency-free canvas viewer (drag-rotate, frame slider, chi color).
_MOL_PAGE = """<!doctype html>
<html><head><title>isokann_tpu_torch molecule</title>
<style>body{font-family:sans-serif;background:#111;color:#eee;text-align:center}
canvas{background:#181818;border-radius:6px;margin:8px}</style></head>
<body><h3>molecule &mdash; frames colored by &chi;</h3>
<canvas id="cv" width="720" height="540"></canvas><br/>
frame <input type="range" id="fr" min="0" value="0" style="width:420px"/>
<span id="lbl"></span>
<script>
let D=null,R=[[1,0,0],[0,1,0],[0,0,1]],drag=null;
const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
const fr=document.getElementById('fr'),lbl=document.getElementById('lbl');
function mul(a,b){let c=[[0,0,0],[0,0,0],[0,0,0]];
 for(let i=0;i<3;i++)for(let j=0;j<3;j++)for(let k=0;k<3;k++)
  c[i][j]+=a[i][k]*b[k][j];return c;}
function rot(ax,ay){const ca=Math.cos(ax),sa=Math.sin(ax),
 cb=Math.cos(ay),sb=Math.sin(ay);
 return mul([[1,0,0],[0,ca,-sa],[0,sa,ca]],[[cb,0,sb],[0,1,0],[-sb,0,cb]]);}
function chicolor(t){t=Math.max(0,Math.min(1,t));
 const r=Math.round(60+195*t),g=Math.round(60+80*(1-Math.abs(t-0.5)*2)),
 b=Math.round(60+195*(1-t));return `rgb(${r},${g},${b})`;}
function draw(){if(!D)return;const f=+fr.value,X=D.frames[f],n=X.length;
 ctx.clearRect(0,0,cv.width,cv.height);
 let c=[0,0,0];for(const p of X){c[0]+=p[0]/n;c[1]+=p[1]/n;c[2]+=p[2]/n;}
 let s=0;for(const p of X)s=Math.max(s,Math.hypot(p[0]-c[0],p[1]-c[1],p[2]-c[2]));
 const sc=0.45*Math.min(cv.width,cv.height)/(s+1e-9);
 const pr=p=>{const q=[p[0]-c[0],p[1]-c[1],p[2]-c[2]];
  return [cv.width/2+sc*(R[0][0]*q[0]+R[0][1]*q[1]+R[0][2]*q[2]),
          cv.height/2-sc*(R[1][0]*q[0]+R[1][1]*q[1]+R[1][2]*q[2]),
          R[2][0]*q[0]+R[2][1]*q[1]+R[2][2]*q[2]];};
 const P=X.map(pr),chi=D.chi[f],col=chicolor(D.chi_lo>=D.chi_hi?0.5:
   (chi-D.chi_lo)/(D.chi_hi-D.chi_lo));
 ctx.strokeStyle=col;ctx.lineWidth=3;ctx.lineCap='round';
 for(const[a,b]of D.bonds){ctx.beginPath();ctx.moveTo(P[a][0],P[a][1]);
  ctx.lineTo(P[b][0],P[b][1]);ctx.stroke();}
 for(const p of P){ctx.beginPath();
  ctx.arc(p[0],p[1],Math.max(2,4+p[2]*sc*0.02),0,7);
  ctx.fillStyle=col;ctx.fill();}
 lbl.textContent=` ${f+1}/${D.frames.length}  chi=${chi.toFixed(3)}`;}
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
 R=mul(rot((e.clientY-drag[1])*0.01,(e.clientX-drag[0])*0.01),R);
 drag=[e.clientX,e.clientY];draw();};
fr.oninput=draw;
async function load(first){const r=await fetch('/mol.json');D=await r.json();
 fr.max=D.frames.length-1;if(first)fr.value=fr.max;draw();}
load(true);setInterval(()=>load(false),5000);
</script></body></html>"""




def _mol_payload(iso, max_frames: int = 120):
    """The last ``max_frames`` start points, the bonds and each frame's
    chi as JSON for the molecule viewer (the reference colors the
    molecule by the frame's chi, ext/MakieExt.jl:209-245)."""
    X = iso.data.coords[-max_frames:]
    chi = iso.chicoords(X)[:, 0].cpu().numpy()
    frames = X.detach().cpu().numpy().astype(np.float32).reshape(
        X.shape[0], -1, 3)
    sysobj = getattr(iso.data.sim, "system", None)
    bonds = getattr(sysobj, "bond_idx", None)
    bonds = [] if bonds is None else _host(bonds).reshape(-1, 2).tolist()
    return json.dumps({
        "frames": np.round(frames, 4).tolist(),
        "bonds": bonds,
        "chi": chi.tolist(),
        "chi_lo": float(chi.min()),
        "chi_hi": float(chi.max()),
    }).encode()


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _status(iso):
    if iso is None:
        return "no run yet &mdash; configure and Apply"
    if not iso.losses:
        return "warming up"
    return (f"iterations: {len(iso.losses)} | data: {len(iso.data)} | "
            f"loss: {iso.losses[-1]:.4g}")


def _reply(handler, code, ctype, data=b""):
    handler.send_response(code)
    if ctype:
        handler.send_header("Content-Type", ctype)
    handler.end_headers()
    handler.wfile.write(data)


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def serve_dashboard(iso, port: int = 8000, refresh: int = 3,
                    host: str = "127.0.0.1"):
    """Serve the live dashboard at http://<host>:<port>/ from a
    background thread.  Returns the server: ``.shutdown()`` and
    ``.server_close()`` stop it."""
    want_rama = iso.data.pdbfile is not None

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                rama = '<img src="/rama.png"/>' if want_rama else ""
                body = _PAGE.format(refresh=refresh, status=_status(iso),
                                    rama=rama).encode()
                _reply(self, 200, "text/html", body)
            elif self.path in ("/training.png", "/rama.png"):
                try:
                    data = _render(iso, want_rama).get(self.path, b"")
                except Exception as e:      # the server keeps running
                    _reply(self, 500, "text/plain", repr(e).encode())
                    return
                _reply(self, 200 if data else 404, "image/png", data)
            else:
                _reply(self, 404, None)

    return _start(http.server.ThreadingHTTPServer((host, port), Handler))


def livegui(iso, iterations: int = 1000, chunk: int = 20, port: int = 8000,
            adaptive_kde: int = 0):
    """Train ``iterations`` iterations in chunks (with ``adaptive_kde``,
    one KDE generation of that many points a chunk) while serving the
    live dashboard (the reference GUI's train-while-watching loop,
    ``ext/MakieExt.jl:42-71``).  Blocks until training ends; the server
    stops then, also on Ctrl-C."""
    srv = serve_dashboard(iso, port=port)
    print(f"live dashboard at http://localhost:{srv.server_address[1]}/")
    try:
        done = 0
        while done < iterations:
            n = min(chunk, iterations - done)
            if adaptive_kde:
                iso.run_kde(generations=1, iter=n, kde=adaptive_kde)
            else:
                iso.run(n)
            done += n
    finally:
        srv.shutdown()
        srv.server_close()
    return iso


# ==========================================================================
# Interactive control panel (reference GUI sliders, ext/MakieExt.jl:18-80)
# ==========================================================================

_FORM = """<form method="post" action="/control" style="margin:10px">
<input type="hidden" name="token" value="{token}"/>
<fieldset style="display:inline-block;text-align:left;border-color:#444">
<legend>simulation / training</legend>
pdb <input name="pdb" value="{pdb}" size="28"/>
steps <input name="steps" value="{steps}" size="5"/>
temp [K] <input name="temp" value="{temp}" size="5"/><br/>
nx <input name="nx" value="{nx}" size="5"/>
nk <input name="nk" value="{nk}" size="4"/>
opt <select name="opt">
<option value="adam" {sel_adam}>Adam</option>
<option value="nesterov" {sel_nest}>Nesterov</option></select>
lr <input name="lr" value="{lr}" size="8"/>
reg <input name="reg" value="{reg}" size="8"/><br/>
kde/gen <input name="kde" value="{kde}" size="4"/>
<button name="action" value="apply">Apply &amp; restart</button>
<button name="action" value="toggle">{toggle}</button>
</fieldset></form>"""


class InteractiveGui:
    """Browser control panel and a live training loop.

    The reference GUI has sliders for pdb, steps, temperature, optimizer,
    learning rate, regularization, nx and nk, and trains while one
    watches (``ext/MakieExt.jl:18-80``).  Here an HTML form (re)builds the
    ``MDSimulation`` and the ``Iso`` on ``device`` (the card unless the
    caller names another), a background thread trains them in chunks of
    ``chunk`` iterations (with ``kde``, one KDE generation a chunk) and
    the dashboard images refresh live.  ``shutdown()`` stops the server
    and joins the training thread.
    """

    def __init__(self, pdb=None, steps=100, temp=310.0, nx=64, nk=4,
                 opt="adam", lr=1e-3, reg=1e-4, kde=0, chunk=25,
                 device=None):
        self.cfg = dict(pdb=pdb or "", steps=int(steps), temp=float(temp),
                        nx=int(nx), nk=int(nk), opt=opt, lr=float(lr),
                        reg=float(reg), kde=int(kde))
        self.chunk = int(chunk)
        self.device = device
        self.running = False
        self.iso = None
        self.error = None      # the exception that paused training
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = None
        self._srv = None
        # a per-session token: /control posts must echo it, so that another
        # web page cannot post to the localhost endpoint (which reads any
        # file path and starts compute)
        self._token = secrets.token_urlsafe(16)

    def _build(self):
        from ..iso import Iso
        from ..optim import AdamRegularized, NesterovRegularized
        from ..simulators.mdsim import MDSimulation

        c = self.cfg
        sim = MDSimulation(pdb=c["pdb"] or None, steps=c["steps"],
                           temp=c["temp"], device=self.device)
        opt = (AdamRegularized(c["lr"], c["reg"]) if c["opt"] == "adam"
               else NesterovRegularized(c["lr"], c["reg"]))
        self.iso = Iso(sim=sim, nx=c["nx"], nk=c["nk"], opt=opt)

    def _train_loop(self):
        while not self._stop.is_set():
            if not self.running or self.iso is None:
                self._stop.wait(0.2)
                continue
            try:
                with self.lock:
                    if self.cfg["kde"]:
                        self.iso.run_kde(generations=1, iter=self.chunk,
                                         kde=self.cfg["kde"])
                    else:
                        self.iso.run(self.chunk)
            except Exception as e:       # degenerate targets etc.: pause
                print(f"[gui] training paused: {e!r}")
                self.error = e
                self.running = False

    def apply(self, form):
        """Apply a /control form submission (a ``parse_qs`` dict)."""
        with self.lock:
            for k in self.cfg:
                if k in form:
                    cast = type(self.cfg[k])
                    try:
                        self.cfg[k] = cast(form[k][0])
                    except (TypeError, ValueError):
                        pass
            action = form.get("action", ["apply"])[0]
            if action == "toggle":
                self.running = not self.running and self.iso is not None
            else:
                self.running = False
                self._build()
                self.running = True

    def _page(self, refresh):
        iso = self.iso
        c = {k: html.escape(str(v), quote=True) for k, v in self.cfg.items()}
        form = _FORM.format(
            token=self._token,
            toggle="Pause" if self.running else "Resume",
            sel_adam="selected" if self.cfg["opt"] == "adam" else "",
            sel_nest="selected" if self.cfg["opt"] != "adam" else "",
            **c)
        live = iso is not None and bool(iso.losses)
        imgs = '<img src="/training.png"/>' if live else ""
        mol = ('<p><a href="/mol" style="color:#8cf">live 3-D molecule '
               '(chi-colored)</a></p>' if live else "")
        body = _PAGE.format(refresh=refresh, status=_status(iso) + form,
                            rama=(imgs and '<img src="/rama.png"/>') + mol)
        return body.replace('<img src="/training.png"/><br/>',
                            imgs + "<br/>").encode()

    def serve(self, port: int = 8000, refresh: int = 3,
              host: str = "127.0.0.1"):
        """Start the server and the training thread; returns the server."""
        gui = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                iso = gui.iso
                if self.path in ("/", "/index.html"):
                    _reply(self, 200, "text/html", gui._page(refresh))
                elif self.path in ("/training.png", "/rama.png"):
                    data = b""
                    if iso is not None and iso.losses:
                        try:
                            with gui.lock:
                                data = _render(
                                    iso, iso.data.pdbfile is not None
                                ).get(self.path, b"")
                        except Exception as e:  # the server keeps running
                            _reply(self, 500, "text/plain",
                                   repr(e).encode())
                            return
                    _reply(self, 200 if data else 404, "image/png", data)
                elif self.path == "/mol":
                    _reply(self, 200, "text/html", _MOL_PAGE.encode())
                elif self.path == "/mol.json":
                    data = b""
                    if iso is not None:
                        try:
                            with gui.lock:
                                data = _mol_payload(iso)
                        except Exception as e:  # the server keeps running
                            _reply(self, 500, "text/plain",
                                   repr(e).encode())
                            return
                    _reply(self, 200 if data else 404, "application/json",
                           data)
                else:
                    _reply(self, 404, None)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                form = urllib.parse.parse_qs(
                    self.rfile.read(length).decode())
                if form.get("token", [""])[0] != gui._token:
                    _reply(self, 403, None, b"bad or missing CSRF token")
                    return
                gui.apply(form)
                self.send_response(303)
                self.send_header("Location", "/")
                self.end_headers()

        self._srv = _start(http.server.ThreadingHTTPServer((host, port),
                                                           Handler))
        self._worker = threading.Thread(target=self._train_loop, daemon=True)
        self._worker.start()
        return self._srv

    def shutdown(self, timeout=None):
        """Stop the server and the training thread (joined: it ends after
        its current chunk; ``timeout`` seconds at most, if given)."""
        self._stop.set()
        self.running = False
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
        if self._worker is not None:
            self._worker.join(timeout)


def interactive_gui(port: int = 8000, **kwargs) -> InteractiveGui:
    """Start the interactive control panel at http://localhost:<port>/
    (the reference's ``ISOKANN.bonito_gui()``)."""
    gui = InteractiveGui(**kwargs)
    srv = gui.serve(port=port)
    print(f"interactive dashboard at http://localhost:"
          f"{srv.server_address[1]}/")
    return gui
