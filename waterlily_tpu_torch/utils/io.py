"""Checkpoint / restart and VTK export.

PyTorch counterpart of `waterlily_tpu/utils/io.py` (the reference's I/O
extensions):

* `save_state`/`load_state`: ``(p, u, dt history)`` and, with a `MeanFlow`,
  its ``P, U, UU, t`` in one ``.npz`` (the JLD2 extension,
  `ext/WaterLilyJLD2Ext.jl`).  The keys and layouts are the JAX package's,
  so a checkpoint of either package loads into the other.  The body is not
  saved: the simulation that loads keeps its own measure.
* `VTKWriter`: one ``.vti`` (XML ImageData) per write and a ``.pvd``
  collection for ParaView (`ext/WaterLilyWriteVTKExt.jl`); `load_vtk`
  restarts from the last ``.vti`` of a collection and rebuilds the time
  step history (`ext/WaterLilyReadVTKExt.jl:22-43`).

`save`/`load` dispatch on the extension (`src/WaterLily.jl:166-174`).  The
JAX package's orbax checkpoints (``.ckpt``) have no counterpart here.
Restoring sets ``p``, ``u`` and ``u0`` of ``sim.flow.state`` and the Δt
history; every engine steps that state, so nothing else is refreshed.
"""
from __future__ import annotations

import base64
import dataclasses
import os
import struct
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np
import torch

__all__ = ["save_state", "load_state", "VTKWriter", "load_vtk", "save", "load"]

_ORBAX = ("orbax checkpoints (.ckpt) are not supported by the PyTorch port; "
          "use .npz")


def _host(a) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _dense_u(sim) -> np.ndarray:
    return _host(sim.flow.state.u)


def _dense_p(sim) -> np.ndarray:
    return _host(sim.flow.state.p)


def _restore_fields(sim, u, p):
    """Put host ``u``/``p`` into the simulation's state (``u0 = u``) in its
    dtype and on its device."""
    st = sim.flow.state
    kw = dict(dtype=sim.flow.cfg.dtype, device=st.u.device)
    u = torch.as_tensor(np.ascontiguousarray(u), **kw)
    sim.flow.state = dataclasses.replace(
        st, p=torch.as_tensor(np.ascontiguousarray(p), **kw), u=u, u0=u)


def _check_shapes(sim, p, u):
    """The size check of `WaterLilyJLD2Ext.jl:30-41`."""
    D = sim.flow.cfg.D
    pshape, ushape = tuple(sim.flow.cfg.shape), (D,) + tuple(sim.flow.cfg.shape)
    if tuple(p.shape) != pshape or tuple(u.shape) != ushape:
        raise ValueError(f"checkpoint shapes p{tuple(p.shape)}/u{tuple(u.shape)}"
                         f" != sim p{pshape}/u{ushape}")


# ------------------------------------------------------------- npz checkpoint
def save_state(fname: str, sim, meanflow=None):
    """Checkpoint ``(p, u, dt)`` and the `MeanFlow` statistics if given."""
    data = {"p": _dense_p(sim), "u": _dense_u(sim),
            "dt": np.asarray(sim.flow.dt, np.float64)}
    if meanflow is not None:
        data["mf_P"] = _host(meanflow.P)
        data["mf_U"] = _host(meanflow.U)
        if meanflow.UU is not None:
            data["mf_UU"] = _host(meanflow.UU)
        data["mf_t"] = np.asarray(meanflow.t, np.float64)
    np.savez(fname, **data)


def load_state(fname: str, sim, meanflow=None):
    """Restore ``(p, u, dt)`` into ``sim`` (size-checked) and the `MeanFlow`
    statistics into ``meanflow`` (on its device and in its dtype)."""
    with np.load(fname) as d:
        p, u = d["p"], d["u"]
        _check_shapes(sim, p, u)
        _restore_fields(sim, u, p)
        sim.flow.dt = [float(x) for x in d["dt"]]
        if meanflow is not None and "mf_P" in d:
            kw = dict(dtype=meanflow.P.dtype, device=meanflow.P.device)
            meanflow.P = torch.as_tensor(d["mf_P"], **kw)
            meanflow.U = torch.as_tensor(d["mf_U"], **kw)
            if "mf_UU" in d:
                meanflow.UU = torch.as_tensor(d["mf_UU"], **kw)
            meanflow.t = [float(x) for x in d["mf_t"]]
    return sim


# ------------------------------------------------------------- VTK
def _write_vti(fname: str, fields: dict[str, np.ndarray], extent: tuple[int, ...]):
    D = len(extent)
    ext6 = list(extent) + [1] * (3 - D)
    ext_str = f"0 {ext6[0]-1} 0 {ext6[1]-1} 0 {ext6[2]-1}"
    root = ET.Element("VTKFile", {"type": "ImageData", "version": "1.0",
                                  "byte_order": "LittleEndian"})
    img = ET.SubElement(root, "ImageData", {"WholeExtent": ext_str,
                                            "Origin": "0 0 0", "Spacing": "1 1 1"})
    piece = ET.SubElement(img, "Piece", {"Extent": ext_str})
    pd = ET.SubElement(piece, "PointData")
    for name, arr in fields.items():
        # VTK wants x fastest; the arrays are x-major: transpose
        if arr.ndim == D:          # scalar
            a = np.transpose(arr)
            ncomp = "1"
        else:                      # vector (D, *sp) -> (*sp reversed, 3)
            comps = [np.transpose(arr[i]) for i in range(arr.shape[0])]
            while len(comps) < 3:
                comps.append(np.zeros_like(comps[0]))
            a = np.stack(comps, axis=-1)
            ncomp = "3"
        el = ET.Element("DataArray", {"type": "Float32", "Name": name,
                                      "NumberOfComponents": ncomp,
                                      "format": "binary"})
        payload = np.ascontiguousarray(a, np.float32).tobytes()
        el.text = base64.b64encode(struct.pack("<I", len(payload)) + payload).decode()
        pd.append(el)
    ET.ElementTree(root).write(fname, xml_declaration=True)


def _read_vti(fname: str) -> dict[str, np.ndarray]:
    root = ET.parse(fname).getroot()
    ext = root.find("ImageData").get("WholeExtent").split()
    nx, ny, nz = (int(ext[1]) + 1, int(ext[3]) + 1, int(ext[5]) + 1)
    shape = [ny, nx] if nz == 1 else [nz, ny, nx]
    out = {}
    for el in root.iter("DataArray"):
        blob = base64.b64decode(el.text.strip())
        (nbytes,) = struct.unpack("<I", blob[:4])
        a = np.frombuffer(blob[4:4 + nbytes], np.float32)
        ncomp = int(el.get("NumberOfComponents", "1"))
        if ncomp == 1:
            out[el.get("Name")] = np.transpose(a.reshape(shape))
        else:
            a = a.reshape(shape + [ncomp])
            out[el.get("Name")] = np.stack([np.transpose(a[..., i])
                                            for i in range(ncomp)])
    return out


def default_attrib() -> dict:
    """The default VTK fields (`default_attrib`, `WriteVTKExt.jl:16-19`):
    velocity and pressure."""
    return {"Velocity": _dense_u, "Pressure": _dense_p}


class VTKWriter:
    """ParaView collection writer (`vtkWriter`, `WriteVTKExt.jl:21-73`): one
    ``.vti`` per `write`, indexed by a ``.pvd`` collection with the physical
    times.  ``attrib`` maps field names to ``sim -> array`` closures
    (default: velocity and pressure)."""

    def __init__(self, fname: str = "waterlily", attrib: Optional[dict] = None,
                 dirname: str = "vtk_data"):
        self.fname = fname
        self.dir = dirname
        os.makedirs(dirname, exist_ok=True)
        self.attrib = attrib or default_attrib()
        self.entries: list[tuple[float, str]] = []
        self.count = 0

    def write(self, sim):
        """Append one time: every attrib closure on the sim into a ``.vti``,
        and the ``.pvd`` collection rewritten."""
        fields = {k: _host(f(sim)) for k, f in self.attrib.items()}
        path = os.path.join(self.dir, f"{self.fname}_{self.count:06d}.vti")
        _write_vti(path, fields, tuple(sim.flow.cfg.shape))
        self.entries.append((sim.time, path))
        self.count += 1
        self._write_pvd()

    def _write_pvd(self):
        root = ET.Element("VTKFile", {"type": "Collection", "version": "1.0"})
        col = ET.SubElement(root, "Collection")
        for t, path in self.entries:
            ET.SubElement(col, "DataSet", {"timestep": repr(t), "part": "0",
                                           "file": path})
        ET.ElementTree(root).write(self.fname + ".pvd", xml_declaration=True)

    def close(self):
        """Finalize the ``.pvd`` collection (`close`, `WriteVTKExt.jl:73`)."""
        self._write_pvd()


def load_vtk(sim, fname: str = "waterlily.pvd"):
    """Restart from the last ``.vti`` of a collection: restores ``p`` and
    ``u`` and rebuilds the Δt history from the file times so that stepping
    continues (`WaterLilyReadVTKExt.jl:22-43`).  Returns ``(sim, writer)``
    with an append-mode `VTKWriter`."""
    root = ET.parse(fname).getroot()
    entries = [(float(d.get("timestep")), d.get("file"))
               for d in root.iter("DataSet")]
    fields = _read_vti(entries[-1][1])
    u = fields["Velocity"][: len(sim.flow.cfg.shape)]
    p = fields["Pressure"]
    _check_shapes(sim, p, u)
    _restore_fields(sim, u, p)
    sim.flow.dt = _dt_hist(entries)
    writer = VTKWriter(fname[:-4] if fname.endswith(".pvd") else fname)
    writer.entries = list(entries)
    writer.count = len(entries)
    return sim, writer


def _dt_hist(entries):
    """A Δt history whose prefix sums to the restart time, and a pending
    step equal to the last interval."""
    ts = [t for t, _ in entries]
    dts = [ts[0]] if ts[0] > 0 else []
    dts += [b - a for a, b in zip(ts[:-1], ts[1:]) if b > a]
    if not dts:
        dts = [0.25]
    return dts + [dts[-1]]


# ------------------------------------------------------------- dispatch
def save(fname: str, sim, **kw):
    """Save by extension (`src/WaterLily.jl:166-174`): ``.npz``."""
    if fname.endswith(".npz"):
        return save_state(fname, sim, **kw)
    if fname.endswith(".ckpt"):
        raise ValueError(_ORBAX)
    raise ValueError(f"unsupported checkpoint format: {fname}")


def load(fname: str, sim, **kw):
    """Restore by extension (`load!`, `WaterLily.jl:166-174`): an ``.npz``
    state or a ``.pvd`` VTK collection."""
    if fname.endswith(".npz"):
        return load_state(fname, sim, **kw)
    if fname.endswith(".pvd"):
        return load_vtk(sim, fname)
    if fname.endswith(".ckpt"):
        raise ValueError(_ORBAX)
    raise ValueError(f"unsupported checkpoint format: {fname}")
