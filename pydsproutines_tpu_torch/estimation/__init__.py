"""Estimation / geometry layer: localization grid searches, the CRB
framework, coordinates, trajectories, geometry, ellipse fusion and
clustering, with the JAX package's public names.

The grid searches, range rate and Doppler run in torch on a device (the
card unless ``device`` names another); the small-matrix CRB and geometry
algebra is host numpy, as in the JAX package, whose numpy modules the port
copies.
"""

from pydsproutines_tpu_torch.estimation.coords import (
    geodetic_lla_to_ecef,
    ecef_to_geodetic_lla,
    get_wgs84_tangent_plane_normal,
    get_wgs84_tangent_plane_north_east,
)
from pydsproutines_tpu_torch.estimation.localization import (
    calculate_range_rate,
    range_difference_of_arrival,
    hyperbola_grad_desc,
    generate_hyperbola_xy,
    grid_search_blind_linear_rtt,
    calc_crb_blind_linear_rtt,
    GridLocalizer,
    LatLonGridLocalizer,
    TDMixin,
    TDFDMixin,
    BlindLinearRTTMixin,
    TDOAGridLocalizer,
    TDFDGridLocalizer,
    TDOALatLonGridLocalizer,
    TDFDLatLonGridLocalizer,
    calculate_doppler,
    grid_search_tdoa,
    grid_search_fdoa,
    grid_search_tdoa_direct,
    grid_search_tdfd_direct,
    grid_search_rtt,
    latlongrid_to_ecef,
    calc_crb_td,
    calc_crb_tdfd,
    project_crb_to_ellipse,
)
from pydsproutines_tpu_torch.estimation.crb import (
    CRB,
    TDOACRBComponent,
    TOACRBComponent,
    AOA3DCRBComponent,
)
from pydsproutines_tpu_torch.estimation.ellipses import (
    average_ellipses_davis,
    average_ellipses_berkeley,
    point_in_ellipse,
)

from pydsproutines_tpu_torch.estimation.trajectory import (
    Trajectory,
    StationaryTrajectory,
    ConstantVelocityTrajectory,
    InterpolatedTrajectory,
    create_linear_trajectory,
    create_circular_trajectory,
    calc_foa,
    Transceiver,
    Receiver,
    Transmitter,
)
from pydsproutines_tpu_torch.estimation.geometry import (
    Ellipsoid,
    OblateSpheroid,
    WGS84Spheroid,
    Sphere,
    Hyperboloid,
)
from pydsproutines_tpu_torch.estimation.satellites import (
    Satellite,
    parse_tle,
    J2Propagator,
    gmst_rad,
    teme_to_itrs,
    sf_propagate_satellite_to_gpstime,
    sf_geocentric_to_itrs,
)

__all__ = [
    "geodetic_lla_to_ecef",
    "ecef_to_geodetic_lla",
    "get_wgs84_tangent_plane_normal",
    "get_wgs84_tangent_plane_north_east",
    "calculate_range_rate",
    "calculate_doppler",
    "grid_search_tdoa",
    "grid_search_fdoa",
    "grid_search_tdoa_direct",
    "grid_search_tdfd_direct",
    "grid_search_rtt",
    "latlongrid_to_ecef",
    "calc_crb_td",
    "calc_crb_tdfd",
    "project_crb_to_ellipse",
    "CRB",
    "TDOACRBComponent",
    "TOACRBComponent",
    "AOA3DCRBComponent",
    "average_ellipses_davis",
    "average_ellipses_berkeley",
    "range_difference_of_arrival",
    "hyperbola_grad_desc",
    "generate_hyperbola_xy",
    "grid_search_blind_linear_rtt",
    "calc_crb_blind_linear_rtt",
    "GridLocalizer",
    "LatLonGridLocalizer",
    "TDMixin",
    "TDFDMixin",
    "BlindLinearRTTMixin",
    "TDOAGridLocalizer",
    "TDFDGridLocalizer",
    "TDOALatLonGridLocalizer",
    "TDFDLatLonGridLocalizer",
    "Trajectory",
    "StationaryTrajectory",
    "ConstantVelocityTrajectory",
    "InterpolatedTrajectory",
    "create_linear_trajectory",
    "create_circular_trajectory",
    "calc_foa",
    "Transceiver",
    "Receiver",
    "Transmitter",
    "Ellipsoid",
    "OblateSpheroid",
    "WGS84Spheroid",
    "Sphere",
    "Hyperboloid",
    "point_in_ellipse",
    "Satellite",
    "parse_tle",
    "J2Propagator",
    "gmst_rad",
    "teme_to_itrs",
    "sf_propagate_satellite_to_gpstime",
    "sf_geocentric_to_itrs",
]
