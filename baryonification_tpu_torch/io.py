"""Data objects: halo catalogs, HEALPix lightcone shells, gridded maps and
particle snapshots.

The port of the io objects of ``baryonification_tpu.io`` that the shell,
grid and snapshot runners read. They are host-side numpy containers, identical in
layout to the JAX package's, so one catalog recipe feeds both packages;
the runners move what they need to the device.
"""

import warnings

import numpy as np

__all__ = ['HaloLightConeCatalog', 'HaloNDCatalog', 'LightconeShell',
           'GriddedMap', 'ParticleSnapshot']

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
    dict. ``path`` reads a ``.npy`` map (FITS input is not ported yet)."""

    def __init__(self, map=None, path=None, cosmo=None):
        if map is None and path is None:
            raise ValueError("Need either map or path as input")
        if path is not None:
            if str(path).lower().endswith(('.fits', '.fits.gz')):
                raise NotImplementedError(
                    "FITS maps are not ported yet; load the map with "
                    "baryonification_tpu.io.read_healpix_fits and pass map=")
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
