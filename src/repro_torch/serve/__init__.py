"""The reservoir serving stack: arena, scheduler, planes, engine facade."""
