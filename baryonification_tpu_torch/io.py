"""Data objects: halo lightcone catalogs and HEALPix lightcone shells.

The port of the two io objects of ``baryonification_tpu.io`` that the
shell runner reads. They are host-side numpy containers, identical in
layout to the JAX package's, so one catalog recipe feeds both packages;
the runners move what they need to the device.
"""

import warnings

import numpy as np

__all__ = ['HaloLightConeCatalog', 'LightconeShell']

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
