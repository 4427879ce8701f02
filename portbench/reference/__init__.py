"""The plain reference: what the port computes, in plain PyTorch, with no
kernel and nothing imported from the port.  ``<family>.py`` holds one
model family (weights in the port's layout, the loss through the cut,
its work counts); ``common.py`` the pieces they share; ``federated.py``
the federated rounds; ``wire.py`` the server step's compression."""
