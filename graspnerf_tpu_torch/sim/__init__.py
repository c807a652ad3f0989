"""The closed-loop clutter-removal evaluation (graspnerf_tpu/sim/): the
simulator, the domain-randomized renderer, the worlds, the campaign and its
logs. Host numpy and the native tracer; the TSDF fusion runs on the card."""
from .transform import Transform, Rotation
from .world import AnalyticWorld, SimWorld, Label
from .grasp import Grasp, to_voxel_coordinates, from_voxel_coordinates
from .objects import (PrimObject, PrimScene, random_object, TYPE_SPHERE,
                      TYPE_BOX, TYPE_CYLINDER, TYPE_CAPSULE)
from .simulation import ClutterRemovalSim, GripperGeometry
from .render import (DomainRandomizer, render_scene, render_views_to_dir,
                     MATERIAL_CLASSES)
from . import clutter_removal
from . import io
