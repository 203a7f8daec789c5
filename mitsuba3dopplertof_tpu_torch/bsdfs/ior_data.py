"""Complex IOR tables for common conductors (the port's copy of the JAX
package's ``bsdfs/ior_data.py``, with the rgb table ``CONDUCTOR_IOR`` that
the JAX package keeps in ``bsdfs/__init__.py``).

``CONDUCTOR_IOR``: approximate rgb (eta, k) at the sRGB primaries, the
values the rgb variant renders with (public tabulated values, the sources
the reference's spectra distill to). ``CONDUCTOR_SPECTRA``: coarse
resamplings of the same public measurements (Johnson & Christy 1972 for
Au/Ag/Cu; Rakic et al. 1998 for Al) over the visible range, as
(wavelengths_nm, eta, k); the reference loads them from
resources/data/ior/<name>.{eta,k}.spd (include/mitsuba/render/ior.h:100-144).
The spectral variant interpolates them at each lane's hero wavelengths;
the rgb variant only uses their names.
"""

CONDUCTOR_IOR = {
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    "Au": ((0.1431, 0.3749, 1.4424), (3.9831, 2.3857, 1.6032)),
    "Ag": ((0.1553, 0.1163, 0.1380), (4.8283, 3.1222, 2.1457)),
    "Al": ((1.6574, 0.8803, 0.5212), (9.2238, 6.2696, 4.8370)),
    "Cu": ((0.2004, 0.9240, 1.1022), (3.9129, 2.4528, 2.1421)),
    "Cr": ((4.3617, 2.9113, 1.6539), (5.1931, 4.2223, 3.7471)),
    "Ni": ((2.3672, 1.6633, 1.4670), (4.4988, 3.0501, 2.3454)),
    "W": ((4.3707, 3.3002, 2.9982), (3.5006, 2.6048, 2.2731)),
    "TiN": ((1.6484, 1.1465, 1.3831), (3.3684, 2.1214, 1.9460)),
}

CONDUCTOR_SPECTRA = {
    "Au": (
        (400.0, 450.0, 500.0, 532.0, 550.0, 600.0, 650.0, 700.0, 750.0,
         800.0),
        (1.66, 1.43, 0.86, 0.54, 0.43, 0.25, 0.17, 0.16, 0.16, 0.17),
        (1.96, 1.85, 1.90, 2.17, 2.46, 2.99, 3.33, 3.80, 4.26, 4.70),
    ),
    "Ag": (
        (400.0, 450.0, 500.0, 550.0, 600.0, 650.0, 700.0, 750.0, 800.0),
        (0.054, 0.040, 0.050, 0.055, 0.055, 0.052, 0.041, 0.033, 0.037),
        (2.10, 2.46, 2.88, 3.28, 3.72, 4.15, 4.52, 4.93, 5.29),
    ),
    "Cu": (
        (400.0, 450.0, 500.0, 550.0, 583.0, 600.0, 650.0, 700.0, 750.0,
         800.0),
        (1.175, 1.15, 1.12, 1.04, 0.83, 0.47, 0.22, 0.21, 0.22, 0.26),
        (2.21, 2.40, 2.58, 2.59, 2.60, 2.81, 3.43, 3.75, 4.05, 4.47),
    ),
    "Al": (
        (400.0, 450.0, 500.0, 550.0, 600.0, 650.0, 700.0, 750.0, 800.0),
        (0.490, 0.618, 0.769, 0.958, 1.20, 1.47, 1.83, 2.40, 2.80),
        (4.86, 5.47, 6.08, 6.69, 7.26, 7.79, 8.31, 8.62, 8.45),
    ),
}

__all__ = ["CONDUCTOR_IOR", "CONDUCTOR_SPECTRA"]
