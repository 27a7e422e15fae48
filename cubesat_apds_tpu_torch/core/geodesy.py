"""Geodesy: affine geotransforms and WGS84 → ECEF, in float64 numpy (a
copy of the JAX package's core/geodesy.py, which the port does not
import).

Host-side math (numpy, full f64 precision — the device tensors are
float32, and ECEF magnitudes ~6.4e6 m need better than f32's ~0.5 m
granularity). Replaces the reference's GDAL calls:
  * ``geo_transform.apply`` / ``invert`` — 6-coefficient affine pixel↔world
    mapping (reference: geotiff_extractor/src/image_extractor/mod.rs:311-329).
  * GDAL ``SpatialRef``/``CoordTransform`` EPSG:4326 → EPSG:4978 — geodetic
    lat/lon/h → ECEF, here the closed-form WGS84 ellipsoid formulas
    (reference: feature_database/src/elevationdb.rs:92-104).

GDAL geotransform convention (gt = [c0, c1, c2, c3, c4, c5]):
    world_x = c0 + px * c1 + py * c2
    world_y = c3 + px * c4 + py * c5
"""

from __future__ import annotations

import numpy as np

# WGS84 ellipsoid constants.
WGS84_A = 6378137.0                 # semi-major axis [m]
WGS84_F = 1.0 / 298.257223563       # flattening
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)  # first eccentricity squared


def geotransform_apply(gt, px, py):
    """Pixel → world coordinates. gt is [6] (GDAL order)."""
    gt = np.asarray(gt, np.float64)
    wx = gt[0] + px * gt[1] + py * gt[2]
    wy = gt[3] + px * gt[4] + py * gt[5]
    return wx, wy


def geotransform_invert(gt):
    """Invert a 6-coefficient affine geotransform (GDAL GDALInvGeoTransform)."""
    gt = np.asarray(gt, np.float64)
    det = gt[1] * gt[5] - gt[2] * gt[4]
    inv_det = 1.0 / det
    return np.stack(
        [
            (gt[2] * gt[3] - gt[0] * gt[5]) * inv_det,
            gt[5] * inv_det,
            -gt[2] * inv_det,
            (gt[0] * gt[4] - gt[1] * gt[3]) * inv_det,
            -gt[4] * inv_det,
            gt[1] * inv_det,
        ]
    )


def world_to_pixel(gt, wx, wy):
    """World → pixel coordinates via the inverted geotransform."""
    inv = geotransform_invert(gt)
    return geotransform_apply(inv, wx, wy)


def geodetic_to_ecef(lon_deg, lat_deg, h):
    """EPSG:4326 (lon, lat in degrees, ellipsoidal height m) → EPSG:4978 ECEF.

    Closed-form WGS84; replaces GDAL CoordTransform
    (reference: feature_database/src/elevationdb.rs:92-104).
    """
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    sin_lat = np.sin(lat)
    cos_lat = np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    x = (n + h) * cos_lat * np.cos(lon)
    y = (n + h) * cos_lat * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + h) * sin_lat
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1)


def ecef_to_geodetic(xyz):
    """ECEF → (lon°, lat°, h). Bowring's iteration (3 rounds, sub-mm)."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.sqrt(x * x + y * y)
    # Initial latitude guess (spherical), then iterate.
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(3):
        sin_lat = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    sin_lat = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    h = p / np.cos(lat) - n
    return np.rad2deg(lon), np.rad2deg(lat), h
