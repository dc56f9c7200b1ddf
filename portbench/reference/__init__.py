"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch versions (``params``, ``fastmath``, ``fcttre``, ``cuadjtqs``,
``saturation``, ``diagnostics``, ``increment``, ``levelscan``,
``nonlinear``, ``tangent_linear``, ``adjoint``; each file names its source
and commit) and the steps composed from them (:mod:`.steps`).

It imports neither JAX nor anything of either package (the import guard,
:mod:`portbench.guard`, holds it to that), takes nothing the program made,
and works out every derived input again.  A later change to the port's
plain versions does not move it.
"""
