"""The virtual mesh (the ranks of a mesh on one device), the sharding
rules over it and the reductions beyond psum."""
