"""Data objects: halo catalogs, HEALPix lightcone shells, gridded maps and
particle snapshots.

The port of ``baryonification_tpu.io``: the io objects that the shell,
grid and snapshot runners read, and a healpy-compatible FITS reader and
writer for HEALPix maps (plain numpy, no healpy or astropy), through which
``LightconeShell(path=...)`` loads ``.fits`` and ``.fits.gz`` shells. The
objects are host-side numpy containers, identical in layout to the JAX
package's, so one catalog recipe feeds both packages; the runners move
what they need to the device.
"""

import warnings

import numpy as np

__all__ = ['HaloLightConeCatalog', 'HaloNDCatalog', 'LightconeShell',
           'GriddedMap', 'ParticleSnapshot', 'read_healpix_fits',
           'write_healpix_fits']


# ----- HEALPix maps in FITS binary tables (healpy.write_map's layout:
# one BINTABLE HDU of E/D/J/K/I/B columns, RING or NESTED) -----

_TFORM_DTYPES = {'E': '>f4', 'D': '>f8', 'J': '>i4', 'K': '>i8',
                 'I': '>i2', 'B': 'u1'}


def _parse_fits_headers(fh):
    """[(cards, data offset, data bytes)] of every HDU of an open file."""
    out = []
    while True:
        cards = {}
        ended = False
        first = fh.read(2880)
        if len(first) < 2880:
            break
        block = first
        while True:
            for i in range(0, 2880, 80):
                card = block[i:i + 80].decode('ascii', 'replace')
                key = card[:8].strip()
                if key == 'END':
                    ended = True
                    break
                if card[8:10] == '= ':
                    val = card[10:]
                    if val.lstrip().startswith("'"):
                        val = val.split("'")[1].strip()
                    else:
                        val = val.split('/')[0].strip()
                    cards[key] = val
            if ended:
                break
            block = fh.read(2880)
            if len(block) < 2880:
                raise ValueError("truncated FITS header")
        naxis = int(cards.get('NAXIS', '0'))
        nbytes = 0
        if naxis > 0:
            # FITS standard: |BITPIX|/8 * GCOUNT * (PCOUNT + prod NAXISi)
            prod = 1
            for ax in range(1, naxis + 1):
                prod *= int(cards[f'NAXIS{ax}'])
            nbytes = (abs(int(cards.get('BITPIX', '8'))) // 8
                      * int(cards.get('GCOUNT', '1'))
                      * (int(cards.get('PCOUNT', '0')) + prod))
        offset = fh.tell()
        out.append((cards, offset, nbytes))
        fh.seek(offset + -(-nbytes // 2880) * 2880)
    return out


def read_healpix_fits(path, field=0):
    """Read a HEALPix map from a FITS binary table (healpy.write_map
    layout; ``.gz`` files too). Returns column ``field`` as a RING-ordered
    float64 numpy map; NESTED files are reordered by
    ``ops.healpix.nest2ring_all``. A partial-sky file
    (INDXSCHM=EXPLICIT) is refused."""
    import re
    if str(path).lower().endswith('.gz'):
        import gzip
        opener = lambda p: gzip.open(p, 'rb')
    else:
        opener = lambda p: open(p, 'rb')
    with opener(path) as fh:
        hdus = _parse_fits_headers(fh)
        table = next(((c, off, nb) for c, off, nb in hdus
                      if c.get('XTENSION', '').startswith('BINTABLE')),
                     None)
        if table is None:
            raise ValueError(f"{path}: no BINTABLE HDU "
                             "(not a healpy-style HEALPix map file)")
        cards, offset, nbytes = table
        if cards.get('INDXSCHM', 'IMPLICIT').upper().startswith('EXPL'):
            raise NotImplementedError(
                f"{path}: INDXSCHM=EXPLICIT (partial-sky map with a "
                "PIXEL index column) is not supported — read the "
                "PIXEL/SIGNAL columns with field= and assemble manually")
        nrow = int(cards['NAXIS2'])
        tfields = int(cards['TFIELDS'])
        dtl = []
        for i in range(1, tfields + 1):
            m = re.match(r'(\d*)([A-Z])', cards[f'TFORM{i}'].strip())
            rep, code = int(m.group(1) or 1), m.group(2)
            if code not in _TFORM_DTYPES:
                raise ValueError(f"unsupported FITS column type {code!r}")
            dtl.append((f'c{i}', _TFORM_DTYPES[code], (rep,)))
        fh.seek(offset)
        rows = np.frombuffer(fh.read(int(cards['NAXIS1']) * nrow),
                             dtype=np.dtype(dtl), count=nrow)
    m = np.ascontiguousarray(
        rows[f'c{field + 1}']).astype(np.float64).reshape(-1)
    if cards.get('ORDERING', 'RING').upper().startswith('NEST'):
        from .ops import healpix as hpx
        nside = int(round(np.sqrt(m.size / 12)))
        n2r = hpx.nest2ring_all(nside, "cpu").numpy()
        ring = np.empty_like(m)
        ring[n2r] = m
        return ring
    return m


def write_healpix_fits(path, hmap, nest=False):
    """Write a RING-ordered map (array or tensor) as a healpy-compatible
    FITS binary table: one float64 column in rows of 1024 as healpy
    writes them, NESTED with ``nest=True``, gzipped for a ``.gz``
    path."""
    if hasattr(hmap, "detach"):
        hmap = hmap.detach().cpu().numpy()
    hmap = np.asarray(hmap, dtype=np.float64).reshape(-1)
    npix = hmap.size
    nside = int(round(np.sqrt(npix / 12)))
    if 12 * nside * nside != npix:
        raise ValueError(f"map size {npix} is not a valid HEALPix size")
    if nest:
        from .ops import healpix as hpx
        hmap = hmap[hpx.nest2ring_all(nside, "cpu").numpy()]
    rep = 1024 if npix % 1024 == 0 else 1
    nrow = npix // rep

    def block(cards):
        txt = ''.join(c.ljust(80) for c in cards + ['END'])
        return txt.ljust(-(-len(txt) // 2880) * 2880).encode('ascii')

    def card(key, val, comment=''):
        if isinstance(val, str):
            v = f"'{val}'".ljust(20)
        elif isinstance(val, bool):
            v = 'T'.rjust(20) if val else 'F'.rjust(20)
        else:
            v = str(val).rjust(20)
        return f"{key:8s}= {v} / {comment}"[:80]

    primary = block([card('SIMPLE', True), card('BITPIX', 8),
                     card('NAXIS', 0), card('EXTEND', True)])
    header = block([
        card('XTENSION', 'BINTABLE'), card('BITPIX', 8),
        card('NAXIS', 2), card('NAXIS1', 8 * rep),
        card('NAXIS2', nrow), card('PCOUNT', 0), card('GCOUNT', 1),
        card('TFIELDS', 1), card('TFORM1', f'{rep}D'),
        card('TTYPE1', 'TEMPERATURE'),
        card('PIXTYPE', 'HEALPIX'),
        card('ORDERING', 'NESTED' if nest else 'RING'),
        card('NSIDE', nside), card('FIRSTPIX', 0),
        card('LASTPIX', npix - 1), card('INDXSCHM', 'IMPLICIT')])
    data = hmap.astype('>f8').tobytes()
    pad = b'\x00' * ((-len(data)) % 2880)
    if str(path).lower().endswith('.gz'):
        import gzip
        opener = lambda p: gzip.open(p, 'wb')  # mirror the reader's opener
    else:
        opener = lambda p: open(p, 'wb')
    with opener(path) as fh:
        fh.write(primary + header + data + pad)


_COSMO_KEYS = ('Omega_m', 'sigma8', 'h', 'Omega_b', 'n_s', 'w0')


def _validate_cosmo(cosmo):
    if cosmo is None:
        return None
    keys = cosmo.keys() if hasattr(cosmo, 'keys') else ()
    if not all(k in keys for k in _COSMO_KEYS):
        raise ValueError("Not all cosmology parameters provided. I need "
                         "Omega_m, sigma8, h, Omega_b, n_s, w0")
    return dict(cosmo)


class HaloLightConeCatalog:
    """Halos on a lightcone: ra, dec [deg], M [Msun], z, plus arbitrary
    per-halo extra columns."""

    def __init__(self, ra, dec, M, z, cosmo, **arrays):
        t = np.float64
        dtype = ([('M', t), ('z', t), ('ra', t), ('dec', t)]
                 + [(name, t) for name in arrays])
        ra = np.atleast_1d(np.asarray(ra, dtype=t))
        dec = np.atleast_1d(np.asarray(dec, dtype=t))
        cat = np.zeros(len(ra), dtype)

        if np.any(np.abs(dec) == 90):
            warnings.warn("Some halos found with declination exactly at the "
                          "poles. Offsetting these by 4e-5 arcsec")
            dec = np.clip(dec, -90 + 1e-8, 90 - 1e-8)

        cat['ra'] = ra
        cat['dec'] = dec
        cat['z'] = z
        cat['M'] = M
        for name, arr in arrays.items():
            cat[name] = arr

        self.cat = cat
        self.cosmo = _validate_cosmo(cosmo)

    @property
    def data(self):
        return self.cat

    @property
    def cosmology(self):
        return self.cosmo

    def __len__(self):
        return self.cat.size

    def __getitem__(self, key):
        other = {k: self.cat[k][key] for k in self.cat.dtype.names
                 if k not in ('ra', 'dec', 'M', 'z')}
        return HaloLightConeCatalog(ra=self.cat['ra'][key],
                                    dec=self.cat['dec'][key],
                                    M=self.cat['M'][key],
                                    z=self.cat['z'][key],
                                    cosmo=self.cosmo, **other)

    def __str__(self):
        return (f"HaloLightConeCatalog with {self.cat.size} Halos at "
                f"{self.cat['z'].min()} < z < {self.cat['z'].max()}.")


class HaloNDCatalog:
    """Halos at Cartesian x, y (, z) [comoving Mpc] at one redshift; a 2D
    catalog when ``z`` is None. Extra columns may be multi-dimensional
    (e.g. ``A_ell`` of shape (H, 2))."""

    def __init__(self, x, y, M, redshift, cosmo, z=None, **arrays):
        t = np.float64
        dtype = [('M', t), ('x', t), ('y', t), ('z', t)]
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            dtype.append((name, t, arr.shape[1:]) if arr.ndim > 1
                         else (name, t))
        x = np.atleast_1d(np.asarray(x, dtype=t))
        cat = np.zeros(len(x), dtype)
        cat['x'] = x
        cat['y'] = y
        cat['z'] = z if z is not None else np.nan
        cat['M'] = M
        for name, arr in arrays.items():
            cat[name] = arr

        self.cat = cat
        self.redshift = redshift
        self.is2D = z is None
        self.cosmo = _validate_cosmo(cosmo)

    @property
    def data(self):
        return self.cat

    @property
    def cosmology(self):
        return self.cosmo

    def __len__(self):
        return self.cat.size

    def __getitem__(self, key):
        other = {k: self.cat[k][key] for k in self.cat.dtype.names
                 if k not in ('x', 'y', 'M', 'z')}
        z = None if self.is2D else self.cat['z'][key]
        return HaloNDCatalog(x=self.cat['x'][key], y=self.cat['y'][key],
                             M=self.cat['M'][key], redshift=self.redshift,
                             cosmo=self.cosmo, z=z, **other)


class LightconeShell:
    """A full-sky HEALPix map (RING) of mass (or any field) plus a cosmology
    dict. ``path`` reads a ``.fits`` / ``.fits.gz`` map
    (:func:`read_healpix_fits`) or a ``.npy`` one."""

    def __init__(self, map=None, path=None, cosmo=None):
        if map is None and path is None:
            raise ValueError("Need either map or path as input")
        if path is not None:
            if str(path).lower().endswith(('.fits', '.fits.gz')):
                map = read_healpix_fits(path)
            else:
                map = np.load(path)
        self.map = np.asarray(map)

        npix = self.map.size
        nside = int(round(np.sqrt(npix / 12)))
        if 12 * nside * nside != npix:
            raise ValueError(f"Map size {npix} is not a valid HEALPix size")
        self.NSIDE = nside
        self.cosmo = _validate_cosmo(cosmo)

    @property
    def data(self):
        return self.map

    @property
    def cosmology(self):
        return self.cosmo


class GriddedMap:
    """A square (2D) or cubic (3D) periodic grid of mass (or any field)
    with the cell-centre coordinates ``bins`` [comoving Mpc], uniformly
    spaced by ``res``. No coordinate meshgrid is kept: the runners make
    the coordinates they need on the device."""

    def __init__(self, map=None, redshift=None, bins=None, cosmo=None):
        self.map = np.asarray(map)
        self.redshift = redshift
        self.Npix = self.map.shape[0]
        self.bins = np.asarray(bins)
        self.res = float(self.bins[1] - self.bins[0])
        self.is2D = self.map.ndim == 2
        if self.is2D:
            assert self.map.shape[0] == self.map.shape[1], \
                "Maps have to be square"
        else:
            assert (self.map.shape[0] == self.map.shape[1]
                    == self.map.shape[2]), "Maps have to be cubic"
        self.cosmo = _validate_cosmo(cosmo)

    @property
    def data(self):
        return self.map

    @property
    def cosmology(self):
        return self.cosmo


class ParticleSnapshot:
    """Raw particle snapshot: x, y (, z) [comoving Mpc] and mass M in a
    periodic box of side L; a 2D snapshot when ``z`` is None."""

    def __init__(self, x=None, y=None, z=None, M=None, L=None, redshift=None,
                 cosmo=None):
        t = np.float64
        dtype = [('M', t), ('x', t), ('y', t), ('z', t)]
        x = np.atleast_1d(np.asarray(x, dtype=t))
        cat = np.zeros(len(x), dtype)
        cat['x'] = x
        cat['y'] = y
        cat['z'] = z if z is not None else np.nan
        cat['M'] = M if M is not None else np.nan

        self.L = L
        self.cat = cat
        self.redshift = redshift
        self.is2D = z is None
        self.cosmo = _validate_cosmo(cosmo)

    @property
    def data(self):
        return self.cat

    @property
    def cosmology(self):
        return self.cosmo

    def __len__(self):
        return self.cat.size

    def make_map(self, N_grid):
        """Bin the particles into an (N_grid,)^dim mass grid on the host
        (``np.histogramdd`` over [0, L] per axis)."""
        assert np.isnan(self.cat['M']).sum() == 0, (
            "If you want to make a map, provide a value for the particle "
            "mass")
        coords = ['x', 'y'] if self.is2D else ['x', 'y', 'z']
        sample = np.stack([self.cat[c] for c in coords], axis=-1)
        bins = [np.linspace(0, self.L, N_grid + 1)] * len(coords)
        H, _ = np.histogramdd(sample, bins=bins, weights=self.cat['M'])
        return H
