"""The control plane: Eq. 1 cost model, the paper's testbed, device
clustering, the PPO actor and the FedAdapt controller.  ``testbed``,
``env``, ``offload`` and ``clustering`` are numpy copies of the reference's
modules of the same names, so Eq. 1 times and k-means groupings come out
identical; ``agent`` runs the actor in PyTorch."""
