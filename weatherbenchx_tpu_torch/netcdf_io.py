"""netCDF interop: the reference's interchange format for metrics & states.

The port of ``weatherbenchx_tpu/netcdf_io.py``. The reference writes metric
results and ``AggregationState`` dumps with ``xr.Dataset.to_netcdf``
(``beam_pipeline.py:369-404`` via ``beam_utils.atomic_write``) and reloads
states with ``xr.open_dataset`` for statistical inference. Users switching
from the reference therefore hold ``.nc`` files, both netCDF3
(scipy/"classic") and netCDF4 (HDF5) flavors, and expect to keep writing
files their xarray tooling can open.

This module provides that boundary without xarray, netCDF4 or h5py:

* :func:`save_dataset_netcdf`: netCDF3 classic (64-bit offset) via
  ``scipy.io.netcdf_file`` (imported where it is used), with CF-encoded
  time axes and the ``coordinates`` attribute convention, openable by
  xarray everywhere;
* :func:`load_dataset_netcdf`: reads netCDF3 via scipy and netCDF4 through
  the pure-Python HDF5 reader ``hdf5_mini`` (HDF5 dimension scales →
  dims), CF-decoding datetimes/timedeltas, so reference-written files
  (including ``#``-schema AggregationState datasets) load directly into
  ``dict[str, DimArray]``. (The JAX package reads netCDF4 through h5py
  where it is installed; the port's machines have none.)

Everything here is host-side I/O: arrays land as CPU tensors and numpy
coords, and reach the device through the loaders and the evaluator.
"""

from __future__ import annotations

import io as pyio
import os
import warnings
from typing import Any, Mapping, Optional

import numpy as np

from weatherbenchx_tpu_torch import cf
from weatherbenchx_tpu_torch import io as io_lib
from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.zarr_io import _decode_cf_time

Dataset = Mapping[str, DimArray]

_EPOCH_US = np.datetime64('1970-01-01T00:00:00', 'us')
# netCDF3 has no 64-bit integer type, so nanoseconds-since-epoch cannot be
# stored exactly. Integer MICROSECONDS held in float64 are exact out to
# ~285 years (2^53 us), so times are truncated to us resolution and stored
# as exact integer-valued floats; the decoder scales the integer part in
# int64 (see ``zarr_io._decode_cf_time``), so >=us-resolution timestamps
# round-trip bit-exactly.
_TIME_UNITS = 'microseconds since 1970-01-01'
_STRLEN_SUFFIX = '_strlen'


def _encode_values(name: str, values: np.ndarray):
  """numpy array → (netCDF3-typed array, extra string dim or None, attrs)."""
  attrs: dict[str, Any] = {}
  v = np.asarray(values)
  if v.dtype.kind == 'M':
    us = (v.astype('datetime64[us]') - _EPOCH_US).astype(np.int64)
    attrs.update(units=_TIME_UNITS, calendar='proleptic_gregorian')
    return us.astype(np.float64), None, attrs
  if v.dtype.kind == 'm':
    attrs['units'] = 'microseconds'
    return v.astype('timedelta64[us]').astype(np.int64).astype(
        np.float64), None, attrs
  if v.dtype.kind == 'b':
    attrs['dtype'] = 'bool'
    return v.astype(np.int8), None, attrs
  if v.dtype.kind in 'US':
    b = np.char.encode(v.astype(str), 'utf-8')
    n = max(1, b.dtype.itemsize)
    b = b.astype(f'S{n}')
    chars = np.ascontiguousarray(b)[..., None].view('S1')
    return chars, (f'{name}{_STRLEN_SUFFIX}', n), attrs
  if v.dtype.kind == 'u' and v.dtype.itemsize <= 2:
    # classic has no unsigned types: widen to the next signed type
    return v.astype(np.int16 if v.dtype.itemsize == 1 else np.int32
                    ), None, attrs
  if v.dtype.kind in 'iu' and v.dtype.itemsize > 2:
    if v.size and (int(v.max(initial=0)) > np.iinfo(np.int32).max
                   or int(v.min(initial=0)) < np.iinfo(np.int32).min):
      # classic has no int64: store as float64 (reads back as float64).
      # Exact only out to 2^53 — beyond that the round-trip silently
      # loses precision, so refuse, like the 4 GiB / record-dim limits.
      if (int(v.max(initial=0)) > 2**53 or int(v.min(initial=0)) < -2**53):
        raise ValueError(
            f'variable {name!r}: int64 values beyond ±2^53 cannot be '
            'stored exactly in netCDF3 classic (no 64-bit integer type; '
            'float64 fallback would lose precision) — use .zarr/.npz')
      warnings.warn(
          f'variable {name!r}: int64 values outside int32 range are '
          'stored as float64 in netCDF3 classic and read back as float64',
          stacklevel=2)
      return v.astype(np.float64), None, attrs
    if v.dtype != np.int32:
      return v.astype(np.int32), None, attrs
  if v.dtype == np.float16:
    return v.astype(np.float32), None, attrs
  return v, None, attrs


def save_dataset_netcdf(path_or_file, dataset: Dataset) -> None:
  """Writes a dict[var, DimArray] dataset as netCDF3 classic (v2).

  Mirrors the layout xarray's scipy backend produces: one variable per
  coordinate (shared across data variables — mismatches raise), CF time
  encoding, non-dim coordinates listed in each variable's ``coordinates``
  attribute, string arrays as char matrices over a ``*_strlen`` dim.
  """
  from scipy.io import netcdf_file

  nc = netcdf_file(path_or_file, mode='w', version=2)
  try:
    dims_written: dict[str, int] = {}
    coords_written: dict[str, tuple] = {}
    vars_written: set[str] = set()

    def ensure_dim(d: str, n: int) -> None:
      if d in dims_written:
        if dims_written[d] != n:
          raise ValueError(
              f'dimension {d!r} has inconsistent lengths '
              f'{dims_written[d]} vs {n}')
        return
      if n == 0 and 0 in dims_written.values():
        # length-0 maps to the netCDF3 unlimited record dim, of which a
        # file may have exactly one.
        raise ValueError(
            'netCDF3 allows at most one zero-length (record) dimension; '
            f'{d!r} is the second — use .zarr/.npz for this dataset')
      dims_written[d] = n
      nc.createDimension(d, n)

    def put_var(name: str, values: np.ndarray, dims, extra_attrs=None):
      if name in vars_written:
        # e.g. a data variable named like another variable's dimension:
        # scipy would silently replace the first definition.
        raise ValueError(
            f'variable name {name!r} is used twice (a data variable '
            'colliding with a coordinate?); netCDF stores one variable '
            'per name')
      vars_written.add(name)
      data, strdim, attrs = _encode_values(name, values)
      if data.nbytes > 2**32 - 4:
        raise ValueError(
            f'variable {name!r} is {data.nbytes} bytes; netCDF3 classic '
            'caps variables at 4 GiB — use .zarr for arrays this large')
      dims = tuple(str(d) for d in dims)
      for d, n in zip(dims, data.shape):
        ensure_dim(d, n)
      if strdim is not None:
        ensure_dim(*strdim)
        dims = dims + (strdim[0],)
      var = nc.createVariable(name, data.dtype, dims)
      if data.ndim:
        var[:] = data
      else:
        # scipy's assignValue does data[:] = v, which 0-d arrays reject.
        var.data[...] = data
      for k, a in {**attrs, **(extra_attrs or {})}.items():
        setattr(var, k, a)

    for var_name, da in dataset.items():
      aux = []
      for cname, c in da.coords.items():
        cvals = np.asarray(c.values)
        if cname not in tuple(da.dims):
          aux.append(str(cname))
        if not cf.check_shared_coord(coords_written, cname, c.dims, cvals,
                                     'a netCDF file'):
          continue
        put_var(str(cname), cvals, c.dims)
      extra = {'coordinates': ' '.join(aux)} if aux else None
      put_var(str(var_name), np.asarray(da.values), da.dims,
              extra_attrs=extra)
  finally:
    nc.close()  # flushes


def dumps_dataset_netcdf(dataset: Dataset) -> bytes:
  """Serializes to netCDF3 bytes (via a temp file: scipy's writer
  corrupts output when flushed into a BytesIO more than once)."""
  import tempfile
  with tempfile.NamedTemporaryFile(suffix='.nc', delete=False) as f:
    tmp = f.name
  try:
    save_dataset_netcdf(tmp, dataset)
    with open(tmp, 'rb') as f:
      return f.read()
  finally:
    os.unlink(tmp)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _attr_str(v) -> Any:
  if isinstance(v, bytes):
    return v.decode('utf-8', 'replace')
  if isinstance(v, np.ndarray) and v.dtype.kind == 'S' and v.size == 1:
    return v.item().decode('utf-8', 'replace')
  return v


def _decode_var(name: str, data: np.ndarray, dims: tuple,
                attrs: dict) -> tuple[np.ndarray, tuple]:
  """Applies CF decoding: chars→str, fill→NaN, packing, time units."""
  attrs = {k: _attr_str(v) for k, v in attrs.items()}
  if (data.dtype.kind == 'S' and data.dtype.itemsize == 1 and dims
      and (dims[-1].endswith(_STRLEN_SUFFIX) or dims[-1].startswith('string'))):
    n = data.shape[-1]
    flat = np.ascontiguousarray(data).view(f'S{max(n, 1)}')[..., 0]
    return np.char.decode(flat, 'utf-8'), dims[:-1]
  if data.dtype.kind == 'O':  # h5py vlen strings
    decode = lambda x: x.decode('utf-8') if isinstance(x, bytes) else str(x)
    return np.vectorize(decode, otypes=[object])(data).astype(str), dims
  out = data
  fill = attrs.get('_FillValue', attrs.get('missing_value'))
  scale, offset = attrs.get('scale_factor'), attrs.get('add_offset')
  # CF order: identify fill sentinels in the PACKED values, then unpack —
  # unpacking first would turn the sentinel into a plausible-looking
  # number (e.g. int16 -32767 × scale + offset).
  fill_mask = None
  if fill is not None and not np.isnan(np.asarray(fill, np.float64)).all():
    fill_mask = out == np.asarray(fill, out.dtype)
  if scale is not None or offset is not None:
    out = out * (scale if scale is not None else 1.0) + (
        offset if offset is not None else 0.0)
  if fill_mask is not None and out.dtype.kind == 'f':
    out = np.where(fill_mask, np.nan, out)
  elif fill_mask is not None and out.dtype.kind in 'iu':
    # Integer data carrying a fill sentinel but no scale/offset: promote to
    # float64 and mask to NaN, matching xarray's mask_and_scale — keeping
    # the raw dtype would let sentinels like -9999 flow into metrics as
    # real values.
    out = np.where(fill_mask, np.nan, out.astype(np.float64))
  if attrs.get('dtype') == 'bool':
    return out.astype(bool), dims
  decoded = _decode_cf_time(out, attrs)
  return decoded, dims


def _assemble(raw: dict[str, tuple]) -> dict[str, DimArray]:
  """{name: (data, dims, attrs)} → DimArray dataset (coords inferred)."""
  arrays = {}
  for name, (data, dims, attrs) in raw.items():
    data, dims = _decode_var(name, np.asarray(data), tuple(dims), attrs)
    arrays[name] = (data, dims, {k: _attr_str(v) for k, v in attrs.items()})

  coord_names = cf.infer_coord_names(arrays)
  coords_all = {n: Coord(arrays[n][1], arrays[n][0]) for n in coord_names}
  out: dict[str, DimArray] = {}
  for name, (data, dims, attrs) in arrays.items():
    if name in coord_names:
      continue
    out[name] = DimArray(data, dims, cf.subset_coords(coords_all, dims))
  return out


def _load_netcdf3(path_or_file) -> dict[str, DimArray]:
  from scipy.io import netcdf_file

  nc = netcdf_file(path_or_file, mode='r', mmap=False)
  try:
    raw = {}
    for name, var in nc.variables.items():
      data = np.asarray(var.data)
      if data.dtype.byteorder == '>':  # netCDF3 stores big-endian
        data = data.astype(data.dtype.newbyteorder('='))
      else:
        data = data.copy()
      raw[str(name)] = (data, tuple(var.dimensions), dict(var._attributes))
    return _assemble(raw)
  finally:
    nc.close()


def _load_netcdf4(path_or_file) -> dict[str, DimArray]:
  """netCDF4 read via the pure-Python HDF5 reader
  (:mod:`weatherbenchx_tpu_torch.hdf5_mini`)."""
  from weatherbenchx_tpu_torch import hdf5_mini

  if isinstance(path_or_file, (str, bytes)) and not (
      isinstance(path_or_file, bytes) and path_or_file[:8]
      == hdf5_mini.SIGNATURE):
    with open(path_or_file, 'rb') as f:
      data = f.read()
  elif isinstance(path_or_file, bytes):
    data = path_or_file
  else:
    data = path_or_file.read()
  datasets = hdf5_mini.read_flat(data)

  def dims_of(name, ds):
    dimlist = ds.attrs.get('DIMENSION_LIST')
    if dimlist is not None:
      return tuple(refs[0] if refs else f'phony_dim_{i}'
                   for i, refs in enumerate(dimlist))
    if ds.attrs.get('CLASS') == b'DIMENSION_SCALE':
      return (name,)
    return tuple(f'phony_dim_{i}' for i in range(np.ndim(ds.data)))

  raw = {}
  for name, ds in datasets.items():
    nc_name = ds.attrs.get('NAME')
    if (ds.attrs.get('CLASS') == b'DIMENSION_SCALE'
        and isinstance(nc_name, bytes)
        and nc_name.startswith(b'This is a netCDF dimension')):
      continue
    attrs = {k: v for k, v in ds.attrs.items()
             if k not in ('DIMENSION_LIST', 'CLASS', 'NAME',
                          'REFERENCE_LIST', '_Netcdf4Dimid',
                          '_Netcdf4Coordinates')}
    raw[name] = (ds.data, dims_of(name, ds), attrs)
  return _assemble(raw)


def load_dataset_netcdf(path: str) -> dict[str, DimArray]:
  """Reads a netCDF file (v3 classic via scipy, v4/HDF5 via hdf5_mini)."""
  with open(path, 'rb') as f:
    magic = f.read(8)
  if magic[:3] == b'CDF':
    return _load_netcdf3(path)
  if io_lib.is_netcdf_bytes(magic):
    return _load_netcdf4(path)
  raise ValueError(f'{path!r} is not a netCDF file (magic {magic!r})')


def loads_dataset_netcdf(data: bytes) -> dict[str, DimArray]:
  if data[:3] == b'CDF':
    return _load_netcdf3(pyio.BytesIO(data))
  if io_lib.is_netcdf_bytes(data):
    return _load_netcdf4(pyio.BytesIO(data))
  raise ValueError('bytes are not a netCDF file')
