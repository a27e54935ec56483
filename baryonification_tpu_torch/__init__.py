"""baryonification_tpu_torch: the PyTorch/CUDA port of baryonification_tpu.

The same models and runners as the JAX package, module for module and
name for name, written in PyTorch for one NVIDIA GPU (Hopper, H100). The
JAX package stays the reference; every ported part is checked against it
on the same inputs (``tests/test_torch_*.py``).

Ported so far:
- the model layer: the Schneider19 (with ShockedGas), Arico20, Mead20
  and Battaglia families, the thermodynamic profiles (pressure,
  temperature, gas density, Compton-y ``ThermalSZ``), and the pixel
  windows (``ConvolvedProfile`` with ``HealPixel``, ``GridPixelApprox``
  or ``NoPix``);
- the shell-baryonify main path: Schneider19 profiles ->
  ``Baryonification2D`` / ``Baryonification3D`` displacement tables (with
  extra parameter axes) -> ``BaryonifyShell.process``;
- the C_ell and painting path: ``TabulatedProfile`` (e.g. of a
  pixel-convolved ``ThermalSZ``) -> ``PaintProfilesShell.process`` ->
  ``ops.spectra`` (``anafast`` and the rest of the SHT);
- the grid runners: ``BaryonifyGrid`` and ``PaintProfilesGrid`` on 2D
  flat-sky maps and 3D boxes (``HaloNDCatalog``, ``GriddedMap``), with
  ``ParamTabulatedProfile`` for painting with per-halo parameters;
- the particle-snapshot runner ``BaryonifySnapshot`` (``ParticleSnapshot``
  with ``make_map``), and the dP(k) analysis layer: ``analysis``
  (``pk_suppression``, ``profile_uk``, ``sheth_tormen_dndlnM``),
  ``Cosmology.P_lin`` / ``P_nl`` (halofit), ``TabulatedCorrelation3D``
  and ``ops.spectra.power_spectrum_3d``;
- the differentiable shell path: ``BaryonifyShell.process_device`` and
  ``PaintProfilesShell.process_device`` (gradients through the cell-major
  kernel's hand-written adjoint and second-order entries),
  ``build_table_device``, ``TabulatedProfile.build_tables_device`` and
  ``cosmology_device``, with ``inference`` (``fit``,
  ``laplace_covariance``, ``hmc_sample``) on top;
- the differentiable grid and snapshot paths (``process_device`` of
  ``BaryonifyGrid``, ``PaintProfilesGrid`` and ``BaryonifySnapshot``);
- ``PaintProfilesAnisGrid``: a profile painted as a function of an
  existing 2D map, both methods, with ``build_remap_device`` and a
  ``process_device`` differentiable in the remap and the canvas map;
- FITS HEALPix maps (``io.read_healpix_fits``, ``write_healpix_fits``,
  ``LightconeShell(path=...)``), the rest of ``ops.healpix`` and
  ``ops.interp``, and the reference's misc utilities;
- ``parallel``: ``SimpleParallel`` and ``SplitJoinParallel`` (runners
  round-robin over the cards), and ``mesh=`` on every runner: the
  cell-major method sharded over the ranks of a ``torch.distributed``
  ``DeviceMesh``, its partial maps joined by ``all_reduce``.
Every runner has two methods: ``cellmajor`` (what ``"auto"`` takes on the
card: candidate lists per coarse cell or block and one pass a bucket; the
shell's pass is the kernel ``csrc/cellmajor_pass.cu``, the grid's and the
snapshot's plain PyTorch ops) and a reference-semantics method (what
``"auto"`` takes on the CPU): ``scatter`` for the shell and grid runners
(halo windows ending in a scatter-add of unsorted rows,
``csrc/scatter_add.cu``), ``gather`` for the snapshot (per-halo blocks of
cell-list cells ending in the same scatter-add). The grid runners end both methods in a CIC redeposit through that
scatter kernel. The two Legendre recurrences of the SHT are
``csrc/legendre_sht.cu``. Every kernel is written by hand in CUDA and
built at first use.

Devices and precision: every entry that makes tensors takes a
``device``, the card by default (``"cuda"``; without a GPU a defaulted
call raises, so pass ``device="cpu"``); there is no global device
state. Model building (cosmology
tables, profile quadratures, displacement tables) runs in float64 on that
device; the runner's per-pixel hot path runs in float32 on CUDA and in
float64 on the CPU (``precision="auto"``).
"""

from . import constants
from . import ops
from . import cosmology
from .cosmology import Cosmology, CosmologyDevice, MassDef, cosmology_device
from . import utils
from .utils import (build_cosmodict, log_time, generate_operator_method,
                    destory_Pk)
from . import io
from .io import (HaloLightConeCatalog, HaloNDCatalog, LightconeShell,
                 GriddedMap, ParticleSnapshot)
from . import profiles
from .profiles import (SchneiderProfiles, DarkMatter, TwoHalo, Stars, Gas,
                       ShockedGas, CollisionlessMatter, DarkMatterOnly,
                       DarkMatterBaryon, Pressure, NonThermalFrac,
                       NonThermalFracGreen20, Temperature, ThermalSZ,
                       ElectronPressure, GasNumberDensity, XrayLuminosity)
from .pixels import ConvolvedProfile, GridPixelApprox, HealPixel, NoPix
from .displacement import (BaryonificationClass, Baryonification2D,
                           Baryonification3D)
from . import runners
from .runners import (DefaultRunner, BaryonifyShell, PaintProfilesShell,
                      PaintProfilesAnisShell, DefaultRunnerGrid,
                      BaryonifyGrid, PaintProfilesGrid,
                      PaintProfilesAnisGrid, DefaultRunnerSnapshot,
                      BaryonifySnapshot)
from .tabulate import (TabulatedProfile, ParamTabulatedProfile,
                       TabulatedCorrelation3D)
from . import analysis
from . import inference
from .inference import (FitResult, fit, laplace_covariance, HMCResult,
                        hmc_sample)
from .default_params import DEFAULT_PARAMS, default_params
from . import parallel
from .parallel import SimpleParallel, SplitJoinParallel

__version__ = "0.1.0"
