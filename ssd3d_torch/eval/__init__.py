from ssd3d_torch.eval.kitti_ap import EvalObject, evaluate_kitti_ap

__all__ = ["evaluate_kitti_ap", "EvalObject"]
