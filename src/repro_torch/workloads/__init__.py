from repro_torch.workloads.base import (FunctionWorkload, GraphIRWorkload, Param,
                                  Workload, WorkloadParamError, as_workload)
from repro_torch.workloads.cnn_zoo import (build_workload, mobilenet_v3_large,
                                     resnet50, unet, vgg16, WORKLOADS)

__all__ = ["FunctionWorkload", "GraphIRWorkload", "Param", "Workload",
           "WorkloadParamError", "as_workload", "build_workload",
           "mobilenet_v3_large", "resnet50", "unet", "vgg16", "WORKLOADS"]
