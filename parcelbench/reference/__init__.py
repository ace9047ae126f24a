"""The benchmark's plain reference: the full convection diagnostics set in
plain torch, independent of the program.

A frozen copy of the program's plain modular path (thermodynamics, LCL,
level ops, parcel profiles, CAPE/CIN, parcel selection, the scalar
diagnostics), kept here unchanged so that the yardstick does not move with
the program, with one difference: every moist adiabat is integrated per
parcel (:mod:`.adiabat`) where the program reads its precomputed tables.
It imports torch alone.
"""
