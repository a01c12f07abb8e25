"""Physical constants (CGS), mirroring the runtime constants the reference pulls from
singularity-opac (``GetRuntimePhysicalConstants``; consumed at
``src/jaybenne/jaybenne.cpp:182-184``).

Only the speed of light ``CC`` and the Stefan-Boltzmann constant ``SB`` are
load-bearing for gray IMC physics; the radiation constant ``AR = 4*SB/CC`` follows.
"""

# Speed of light [cm/s]
CC = 2.99792458e10

# Stefan-Boltzmann constant [erg cm^-2 s^-1 K^-4] (CODATA 2018)
SB = 5.670374419e-5

# Radiation constant a = 4 sigma / c [erg cm^-3 K^-4]
AR = 4.0 * SB / CC

# Boltzmann constant [erg/K]
KB = 1.380649e-16

# Planck constant [erg s]
HH = 6.62607015e-27

# Electron rest mass [g] and Thomson cross section [cm^2]
ME = 9.1093837015e-28
SIGMA_THOMSON = 6.6524587321e-25
