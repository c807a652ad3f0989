"""nn.Modules of the volume and render paths and the training forward;
state-dict keys equal the reference's."""
from .nn_blocks import (InstanceNorm, BasicBlock, ResidualBlock, ConvINElu,
                        UpConv, ResUNetLight, RayFeatInitNet, VisEncoder)
from .dist_decoder import MixtureLogisticsDistDecoder, compute_prob
from .ibrnet import IBRNetNeus, MultiHeadAttention, positional_table, embed_points
from .aggregator import NeusAggregationNet, SingleVariance, neus_alpha
from .grasp_head import VGNConvNet
from .renderer import (NeuralRayRenderer, GraspNeRF, project_to_views,
                       init_parameters_, load_graspnerf, resolve_device)
